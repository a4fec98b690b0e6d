// ssd_scan: the Mamba2 SSD chunked scan, y and the final state h, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:73 ssd_scan_pallas
// (pallas_call body _ssd_kernel), which computes the chunked algorithm of
// src/repro/models/ssm.py:ssd_chunked.  Per (batch, head), x pre-multiplied
// by dt, dA = dt * A, and per tile of L rows along S with a = cumsum(dA):
//
//   y = (C B^T (.) decay) X + exp(a) (.) (C h^T)     decay[i,j] = exp(a_i - a_j), i >= j
//   h <- exp(a[L-1]) h + X^T (B (.) exp(a[L-1] - a))
//
// and h (P x N) is written once, after the last tile.  Head h reads group
// h / (H/G) of B and C by index arithmetic; B and C are never widened to H.
//
// Bound: operations.  At the main path's layer (B=2, S=512, H=32, P=64, G=1,
// N=128) the least work of any form of the scan is the state update and the
// readout, one multiply-add each per (row, head, p, n): 4*B*S*H*P*N = 1.07
// GFLOP over about 20 MB, far above the H100's ridge, so the least time is
// the f32 operations over the 67 TFLOP/s of the CUDA cores.  The tiles'
// causal triangles add 2*B*S*(L+1)/2*(G*N + H*P) to that (1.22 GFLOP at
// L = 64).  This first kernel runs
// f32 FMAs on the CUDA cores out of shared memory (no tensor cores, no TMA):
// a right, simple kernel; wgmma is later work.
//
// Design.
//  - The TPU kernel's sequential chunk axis becomes a loop inside the block:
//    one block owns one (batch, head) and a slice of PT columns of P, and
//    walks S in order with its slice of the state, h^T (N x PT f32), in
//    shared memory.  Each column p of y and of h depends only on column p
//    of x, so the P slices are independent: at the main path's shape the
//    grid is (B*H, P/32) = (64, 2) = 128 blocks for 132 SMs.  Each slice
//    recomputes the decayed scores C B^T (.) decay of its tile.
//  - The tile along S is the kernel's own: kT = 64 rows, whatever `chunk`
//    the caller passes.  The chunked algorithm is exact for any chunk
//    length, so only rounding differs from a 256-row chunk, and a 64-row
//    tile keeps the scores (64 x 64 f32) and B and C (64 x N each) in
//    110.6 KB of shared memory at N = 128, where a 256-row chunk's scores
//    alone would take 256 KiB, more than a block may have (227 KB).  A
//    ragged last tile is loaded as zeros (x = 0 adds nothing, dA = 0
//    decays by 1), so any S runs; the wrapper still asks S % chunk == 0,
//    the TPU kernel's contract.
//  - Above the diagonal a_i - a_j is hundreds above zero at the model's
//    dA (A = -1..-32, dt up to 0.1), and its exp is +inf: the mask is a
//    select BEFORE the exp, never a 0/1 multiply after it (inf * 0 = NaN).
//  - cumsum(dA) over the tile is one warp's shuffle scan; the decay is exp
//    of a difference of those sums, which the plain version (256-row
//    chunks, another order) rounds differently, by about 1e-4 relative
//    where |a| reaches hundreds.
//  - Shared-memory rows are padded to a multiple of 4 floats plus 4, so
//    the 16-byte loads of neighbouring rows fall on distinct banks.
//
// The kernel allocates nothing and launches on the caller's stream; the
// launch error is returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;           // rows of a tile along S
constexpr int kThreads = 256;
constexpr int kTS = kT + 4;      // row stride of the score tile
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared-memory limit

// dtype codes shared with the Python wrapper (Bm and Cm)
enum : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ __forceinline__ int padded_n(int N) { return ((N + 3) & ~3) + 4; }

size_t smem_bytes(int N, int PT) {
  const size_t nr = static_cast<size_t>((N + 3) & ~3);
  const size_t floats = 2 * kT * static_cast<size_t>(padded_n(N))  // C, B
                        + static_cast<size_t>(kT) * kTS             // scores
                        + static_cast<size_t>(kT) * PT              // X
                        + nr * PT                                   // h^T
                        + 3 * kT;                                   // a, exp(a), tail
  return floats * sizeof(float);
}

template <typename BC, int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                const BC* __restrict__ Bm, const BC* __restrict__ Cm,
                float* __restrict__ y, float* __restrict__ hout,
                int S, int H, int G, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const int Nr = (N + 3) & ~3;
  const int NS = padded_n(N);
  float* Cs = smem;              // [kT][NS]  C of the tile
  float* Bs = Cs + kT * NS;      // [kT][NS]  B of the tile
  float* Ss = Bs + kT * NS;      // [kT][kTS] decayed scores, zero above the diagonal
  float* Xs = Ss + kT * kTS;     // [kT][PT]  this block's columns of x
  float* Ht = Xs + kT * PT;      // [Nr][PT]  the state h^T
  float* acum = Ht + Nr * PT;    // [kT]      cumsum of dA over the tile
  float* eacum = acum + kT;      // [kT]      exp(acum)
  float* tail = eacum + kT;      // [kT]      exp(acum[kT-1] - acum)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int hh = blockIdx.x % H;
  const int g = hh / (H / G);
  const int p0 = blockIdx.y * PT;

  for (int i = tid; i < Nr * PT; i += kThreads) Ht[i] = 0.f;
  // the pad columns of B and C stay zero, so loops may run to Nr
  for (int i = tid; i < kT * (NS - N); i += kThreads) {
    const int r = i / (NS - N), c = N + i % (NS - N);
    Cs[r * NS + c] = 0.f;
    Bs[r * NS + c] = 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int rows = min(kT, S - t0);

    // 1. load the tile: C, B (as f32), this block's columns of x, and the
    //    cumsum of dA; rows past S are zeros
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float cv = 0.f, bv = 0.f;
      if (r < rows) {
        const long long off = ((static_cast<long long>(b) * S + t0 + r) * G + g) * N + n;
        cv = to_f32(Cm[off]);
        bv = to_f32(Bm[off]);
      }
      Cs[r * NS + n] = cv;
      Bs[r * NS + n] = bv;
    }
    for (int i = tid; i < kT * PT; i += kThreads) {
      const int r = i / PT, p = i % PT;
      Xs[i] = r < rows ? x[((static_cast<long long>(b) * S + t0 + r) * H + hh) * P + p0 + p] : 0.f;
    }
    if (tid < 32) {
      // inclusive scan, two rows a lane (kT = 64)
      const int r0 = 2 * tid, r1 = r0 + 1;
      const long long base = (static_cast<long long>(b) * S + t0) * H + hh;
      const float a0 = r0 < rows ? dA[base + static_cast<long long>(r0) * H] : 0.f;
      const float a1 = r1 < rows ? dA[base + static_cast<long long>(r1) * H] : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) before = 0.f;
      acum[r0] = before + a0;
      acum[r1] = s;
    }
    __syncthreads();
    if (tid < kT) {
      eacum[tid] = expf(acum[tid]);
      tail[tid] = expf(acum[kT - 1] - acum[tid]);
    }

    // 2. scores: Ss[i][j] = (C_i . B_j) * exp(acum_i - acum_j) for i >= j,
    //    else 0.  Thread (ti, tj) owns rows ti + 16r and columns tj + 16c;
    //    blocks with c > r lie wholly above the diagonal and are skipped.
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < Nr; n += 4) {
        float4 c4[4], b4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          c4[r] = *reinterpret_cast<const float4*>(&Cs[(ti + 16 * r) * NS + n]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b4[c] = *reinterpret_cast<const float4*>(&Bs[(tj + 16 * c) * NS + n]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c > r) continue;
            float v = acc[r][c];
            v = fmaf(c4[r].x, b4[c].x, v);
            v = fmaf(c4[r].y, b4[c].y, v);
            v = fmaf(c4[r].z, b4[c].z, v);
            v = fmaf(c4[r].w, b4[c].w, v);
            acc[r][c] = v;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          float v = 0.f;
          if (i >= j) v = acc[r][c] * expf(acum[i] - acum[j]);  // select, then exp
          Ss[i * kTS + j] = v;
        }
    }
    __syncthreads();

    // 3. y = Ss X + exp(acum) (.) (C h^T) for this block's columns.  Thread
    //    (i0, p) owns rows i0 + RG*r of column p.
    {
      constexpr int RG = kThreads / PT;
      constexpr int RPT = kT / RG;
      const int p = tid % PT, i0 = tid / PT;
      float yd[RPT], yo[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) yd[r] = yo[r] = 0.f;
      const int imax = i0 + RG * (RPT - 1);
      for (int j = 0; j <= imax; j += 4) {  // Ss is zero past each row's diagonal
        const float x0 = Xs[j * PT + p], x1 = Xs[(j + 1) * PT + p];
        const float x2 = Xs[(j + 2) * PT + p], x3 = Xs[(j + 3) * PT + p];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 s4 = *reinterpret_cast<const float4*>(&Ss[(i0 + RG * r) * kTS + j]);
          yd[r] = fmaf(s4.x, x0, fmaf(s4.y, x1, fmaf(s4.z, x2, fmaf(s4.w, x3, yd[r]))));
        }
      }
      for (int n = 0; n < Nr; n += 4) {
        const float h0 = Ht[n * PT + p], h1 = Ht[(n + 1) * PT + p];
        const float h2 = Ht[(n + 2) * PT + p], h3 = Ht[(n + 3) * PT + p];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 c4 = *reinterpret_cast<const float4*>(&Cs[(i0 + RG * r) * NS + n]);
          yo[r] = fmaf(c4.x, h0, fmaf(c4.y, h1, fmaf(c4.z, h2, fmaf(c4.w, h3, yo[r]))));
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = i0 + RG * r;
        if (i < rows)
          y[((static_cast<long long>(b) * S + t0 + i) * H + hh) * P + p0 + p] =
              fmaf(eacum[i], yo[r], yd[r]);
      }
    }
    __syncthreads();

    // 4. state: h^T[n][p] <- exp(acum[kT-1]) h^T[n][p] + sum_j x[j][p] tail[j] B[j][n].
    //    Thread (ng, p) owns 16 consecutive n from ng*16, stepping by NG*16.
    {
      constexpr int NG = kThreads / PT;
      const int p = tid % PT, ng = tid / PT;
      const float dec = eacum[kT - 1];
      for (int n0 = ng * 16; n0 < Nr; n0 += NG * 16) {
        float acc[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = 0.f;
        for (int j = 0; j < kT; ++j) {
          const float xt = Xs[j * PT + p] * tail[j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (n0 + 4 * k < Nr) {
              const float4 b4 = *reinterpret_cast<const float4*>(&Bs[j * NS + n0 + 4 * k]);
              acc[4 * k] = fmaf(xt, b4.x, acc[4 * k]);
              acc[4 * k + 1] = fmaf(xt, b4.y, acc[4 * k + 1]);
              acc[4 * k + 2] = fmaf(xt, b4.z, acc[4 * k + 2]);
              acc[4 * k + 3] = fmaf(xt, b4.w, acc[4 * k + 3]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int n = n0 + k;
          if (n < Nr) Ht[n * PT + p] = fmaf(dec, Ht[n * PT + p], acc[k]);
        }
      }
    }
    __syncthreads();
  }

  // the final state, (P, N) row-major per (batch, head)
  for (int i = tid; i < PT * N; i += kThreads) {
    const int p = i / N, n = i % N;
    hout[((static_cast<long long>(b) * H + hh) * P + p0 + p) * N + n] = Ht[n * PT + p];
  }
}

template <typename BC, int PT>
cudaError_t launch_typed(const float* x, const float* dA, const void* Bm, const void* Cm,
                         float* y, float* h, int B, int S, int H, int G, int P, int N,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(N, PT);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<BC, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H), P / PT);
  ssd_scan_kernel<BC, PT><<<grid, kThreads, smem, stream>>>(
      x, dA, static_cast<const BC*>(Bm), static_cast<const BC*>(Cm), y, h, S, H, G, P, N);
  return cudaGetLastError();
}

template <typename BC>
cudaError_t launch_bc(const float* x, const float* dA, const void* Bm, const void* Cm,
                      float* y, float* h, int B, int S, int H, int G, int P, int N,
                      cudaStream_t stream) {
  if (P % 32 == 0) return launch_typed<BC, 32>(x, dA, Bm, Cm, y, h, B, S, H, G, P, N, stream);
  if (P % 16 == 0) return launch_typed<BC, 16>(x, dA, Bm, Cm, y, h, B, S, H, G, P, N, stream);
  if (P % 8 == 0) return launch_typed<BC, 8>(x, dA, Bm, Cm, y, h, B, S, H, G, P, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (B,S,H,P) f32, dA (B,S,H) f32, Bm / Cm (B,S,G,N) of dtype bc_code, all
// contiguous -> y (B,S,H,P) f32, h (B,H,P,N) f32.  P must be a multiple of
// 8 and H of G.  Returns the cudaError_t of the launch (0 on success).
int ssd_scan_launch(const void* x, const void* dA, const void* Bm, const void* Cm, void* y,
                    void* h, int B, int S, int H, int G, int P, int N, int bc_code,
                    void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || P < 1 || N < 1 || H % G != 0)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(dA);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_code == kF32) return launch_bc<float>(xf, af, Bm, Cm, yf, hf, B, S, H, G, P, N, s);
  if (bc_code == kBF16)
    return launch_bc<__nv_bfloat16>(xf, af, Bm, Cm, yf, hf, B, S, H, G, P, N, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
