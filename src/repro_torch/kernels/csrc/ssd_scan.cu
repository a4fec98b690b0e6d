// ssd_scan: the Mamba2 SSD chunked scan, y and the final state h, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:73 ssd_scan_pallas
// (pallas_call body _ssd_kernel), which computes the chunked algorithm of
// src/repro/models/ssm.py:ssd_chunked.  Per (batch, head), x pre-multiplied
// by dt, dA = dt * A, and per chunk of L rows along S with a = cumsum(dA)
// over the chunk:
//
//   y     = (C B^T (.) decay) X + exp(a) (.) (C h_in^T),  decay[i,j] = exp(a_i - a_j), i >= j
//   h_out = exp(a[L-1]) h_in + (X (.) tail)^T B,          tail[j] = exp(a[L-1] - a_j)
//
// with h_in = 0 entering the first chunk, and the last chunk's h_out
// written as h (P x N).  Head h reads group h / (H/G) of B and C by index
// arithmetic; B and C are never widened to H.  The chunked algorithm is
// exact for any chunk length, so the kernels' chunks are their own (128 or
// 64 rows) whatever `chunk` the caller passes: only rounding differs from
// the plain version's 256-row chunks.  A ragged last chunk loads as zeros
// (x = 0 adds nothing, dA = 0 decays by 1), so any S runs.
//
// Two kernels, chosen by the dtype code of B and C and by nothing else
// (neither is a fallback of the other):
//
//  - bf16 (what the bf16 model gives: the main path): the tensor-core
//    kernel below, three launches a call.
//  - f32: the CUDA-core kernel (ssd_scan_f32_kernel), one launch a call.
//    It serves the f32 cross-checks only.
//
// Bound.  At the main path's layer (B=2, S=512, H=32, P=64, G=1, N=128) the
// least work of any form of the scan is the state update and the readout,
// one multiply-add each per (row, head, p, n): 4*B*S*H*P*N = 1.07 GFLOP,
// 0.0011 ms on the bf16 tensor cores, against 19.5 MB read once and written
// once, 0.0058 ms at 3.35 TB/s: bytes bound it, whatever unit runs the
// operations.  On the f32 CUDA cores alone the same operations take 0.0160
// ms, which is why the bf16 kernel runs them on wgmma.
//
// The bf16 kernel: chunks in parallel, three launches.
//  1. Chunk pass (ssd_scan_chunk_kernel, one warpgroup a block).  Per
//     (batch, group, chunk of kL = 128 rows): C B^T once, shared by the
//     group's heads, written in its accumulator-fragment order (these
//     blocks, the heaviest, come first).  Per (batch, chunk, head, 64
//     columns of P): the chunk's local state (X (.) tail)^T B on wgmma,
//     written to a workspace, and the chunk's decay exp(a[L-1]).
//  2. State pass (ssd_scan_state_kernel): the recurrence over the chunk
//     states, h_in[c+1] = exp(a_c[L-1]) h_in[c] + state_c, P x N
//     elementwise per (batch, head), each chunk's state overwritten in
//     place by the state entering it; the last one is h.
//  3. Output pass (ssd_scan_output_kernel, two warpgroups of 64 rows, two
//     blocks an SM).  Per (batch, chunk, head, 64 columns of P): exp(a) (.)
//     (C h_in^T) on wgmma, then + (C B^T (.) decay) X on wgmma, each depth
//     step's A built in registers while the previous step's products run;
//     written to y.
//  Why three launches and not one chained scan (each chunk's block waiting
//  on its predecessor's published state): the chain is serial in the
//  chunks, a round trip through L2 a chunk (16 at S = 2048), and its blocks
//  must be resident in chunk order.  The state pass is one elementwise
//  sweep whose loads do not wait on the recurrence.  The hand-off costs
//  bytes: one chunk state is P x N f32 = 32 KB a (batch, head), 8.4 MB over
//  the training shape's 4 chunks of 128 (16.8 MB at B=1, S=2048, 33.5 MB at
//  B=4, S=1024), written by pass 1, read and rewritten by pass 2, read by
//  pass 3; 128-row chunks halve it against 64 and fit the training shape's
//  in the 50 MB L2.  Blocks in flight (pass 1 / 3): 264 / 256 at B=2,
//  S=512; 1056 / 1024 at B=4, S=1024; 528 / 512 at B=1, S=2048.
//  Arithmetic: B and C are exact in bf16, x, the decays and h are f32.  So
//    C B^T        one bf16 wgmma, f32 accumulation (exact up to order);
//    C h_in^T     C exact, h_in split into bf16 hi = rn(h), lo = rn(h - hi):
//                 two products;
//    (X tail)^T B the tail on X (B stays exact), X tail split: two products;
//    (C B^T (.) decay) X  both f32: each split, three products (hi.hi +
//                 hi.lo + lo.hi).
//  One bf16 rounding of an f32 operand is not enough: |cumsum dA| reaches
//  hundreds at the model's dA, and tests/test_torch_ssm.py emulates both
//  (split: within the 1e-3 x max hold everywhere; rounded once: not).  The
//  cumsum (one warp's shuffle scan, the same code in passes 1 and 3), the
//  decays (expf) and every sum are f32 on the CUDA cores.  The causal mask
//  is a select BEFORE the exp: above the diagonal a_i - a_j is hundreds
//  above zero and its exp is +inf, so the argument is set to -inf there and
//  the exp gives 0 (never inf * 0 = NaN).
//  Layout: operand tiles are bf16 boxes of [rows][64] swizzled by 128 bytes
//  (wgmma.cuh), written by the threads themselves (f32 operands are split
//  on the way in; any N, P and ragged S pad with zeros in shared memory),
//  then fenced to the async proxy.  C, B and h_in are K-major, X and B as
//  the right-hand side of a register-A product MN-major; X (.) tail and C
//  B^T (.) decay are A operands built in registers, the latter from C B^T
//  stored in the accumulator-fragment order that is also the A layout.
//  N and P run in boxes of 64: the products over N loop over pairs of
//  boxes, each pair issued whole (a box past N is zeros, so no branch
//  splits a wgmma pipeline stage), and the grid runs over P's boxes.  A
//  block issues all its global loads of a tile before its first store to
//  shared memory.
//
// The f32 kernel (the scan's first design, kept for the f32 cross-checks): one block
// owns one (batch, head) and a slice of PT columns of P, and walks S in
// 64-row tiles with its slice of the state, h^T (N x PT f32), in shared
// memory, f32 FMAs out of shared memory; grid (B*H, P/PT).
//
// The backward (ssd_bwd_*, bf16 B/C; no TPU kernel to replace: the Pallas
// scan has no VJP and the JAX trainer differentiates ssd_chunked).  Per
// chunk, with g the gradient of the state leaving it and T = D (.) M, D[i][j]
// = dy_i . x_j, M[i][j] = (C_i . B_j) exp(a_i - a_j) for i >= j:
//
//   g_{c-1} = exp(a_c[L-1]) g_c + (exp(a) (.) dY)^T C,      g_{nc-1} = gh (or 0)
//   dX  = M^T dY + tail (.) (B g^T)
//   dB  = sum_h [(D (.) decay)^T C + tail (.) (X g)]         (over a group's heads)
//   dC  = sum_h [(D (.) decay) B + exp(a) (.) (dY h_in)]
//   da  = T's row sums - its column sums + exp(a) (.) (dY . C h_in^T)
//         - X . dxs, and on the last row sum_j x_j . dxs_j + exp(a[L-1]) <g, h_in>
//   ddA = da's reverse cumsum over the chunk
//
// with dxs = tail (.) (B g^T).  h_in, the state entering each chunk, is the
// forward's workspace as its state pass leaves it: the wrapper keeps it for
// the backward, which launches none of the forward's kernels.
// Bound.  At a pass of the mamba2 cell (B=40, S=2048, H=32, P=64, G=1,
// N=128) the least bytes are x and dy read and dx written (f32), dA read and
// ddA written (f32), B and C read and dB and dC written (bf16): 2.12 GB, 0.632
// ms at 3.35 TB/s; the least operations, the gradients of the forward's two
// products through each of their three operands, 12*B*S*H*P*N = 258 GFLOP,
// 0.261 ms on the bf16 tensor cores: bytes bound it.
// Five launches:
//  1. chunk pass (ssd_bwd_chunk_kernel: chunk_pass<true>, the forward's with
//     B and C swapped): B C^T of each (batch, group, chunk) whole, rows j,
//     in accumulator-fragment order, and each chunk's (exp(a) (.) dY)^T C;
//  2. state pass (ssd_bwd_state_kernel): the recurrence above from the last
//     chunk to the first, each chunk's slot overwritten by its g;
//  3. dx pass (ssd_bwd_dx_kernel, two warpgroups of 64 rows j a block, one
//     block per (batch, chunk, head)): D^T = X dY^T, B g^T and C h_in^T on
//     wgmma; M^T built in registers from B C^T a depth step at a time and
//     fed to M^T dY on wgmma, T's sums taken on the way; da reverse-summed
//     by one warp;
//  4. dB / dC pass (ssd_bwd_dbc_kernel, one block per (batch, chunk, group,
//     split of the group's heads)): W^T = sum_h D^T (.) decay^T in
//     registers, then W^T and W in shared memory for W^T C and W B, and the
//     state terms head by head, each scaled by its row after the product;
//  5. reduce pass (ssd_bwd_reduce_kernel): the splits' partials summed in
//     order and rounded once to bf16.
// The heads of a group are summed inside a block or by the reduce pass,
// never by atomics: two calls give equal bits.  The arithmetic is the
// forward's: B and C exact in bf16, every f32 operand (dY, X, g, h_in, the
// decayed scores M^T and W) split into bf16 hi + lo, the cumsums, exps,
// recurrence and sums in f32, the mask a select before the exp.
//
// The kernels allocate nothing (the wrapper passes the bf16 kernels'
// workspaces, ssd_scan_workspace_bytes and ssd_scan_bwd_workspace_bytes) and
// launch on the caller's stream; the first launch error is returned to the
// caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // an H100 block's shared-memory limit

// dtype codes shared with the Python wrapper (Bm and Cm)
enum : int { kF32 = 0, kBF16 = 1 };

// ---------------------------------------------------------------------------
// f32 B/C: the CUDA-core kernel

constexpr int kT = 64;           // rows of a tile along S
constexpr int kThreads = 256;
constexpr int kTS = kT + 4;      // row stride of the score tile

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

template <int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
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

    // 1. load the tile: C, B, this block's columns of x, and the
    //    cumsum of dA; rows past S are zeros
    for (int i = tid; i < kT * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float cv = 0.f, bv = 0.f;
      if (r < rows) {
        const long long off = ((static_cast<long long>(b) * S + t0 + r) * G + g) * N + n;
        cv = Cm[off];
        bv = Bm[off];
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

template <int PT>
cudaError_t launch_f32_typed(const float* x, const float* dA, const float* Bm, const float* Cm,
                             float* y, float* h, int B, int S, int H, int G, int P, int N,
                             cudaStream_t stream) {
  const size_t smem = smem_bytes(N, PT);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_f32_kernel<PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(H), P / PT);
  ssd_scan_f32_kernel<PT><<<grid, kThreads, smem, stream>>>(x, dA, Bm, Cm, y, h, S, H, G, P, N);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* x, const float* dA, const void* Bm, const void* Cm, float* y,
                       float* h, int B, int S, int H, int G, int P, int N, cudaStream_t stream) {
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  if (P % 32 == 0) return launch_f32_typed<32>(x, dA, bf, cf, y, h, B, S, H, G, P, N, stream);
  if (P % 16 == 0) return launch_f32_typed<16>(x, dA, bf, cf, y, h, B, S, H, G, P, N, stream);
  return launch_f32_typed<8>(x, dA, bf, cf, y, h, B, S, H, G, P, N, stream);
}

// ---------------------------------------------------------------------------
// bf16 B/C: the tensor-core kernel

constexpr int kL = 128;                 // rows of a chunk along S
constexpr int kBoxBytes = kL * 128;     // a [kL][64] bf16 box
constexpr int kXS = 68;                 // row stride (floats) of the chunk pass's f32 X tile
// C B^T of one (batch, group, chunk) in accumulator-fragment order: the
// 64 x 64 block of rows 0-63 (32 registers a thread) and the 64 x 128 block
// of rows 64-127 (64 registers), float4 k of thread t at k * 128 + t
constexpr int kCBFloats = (32 + 64) * 128;
// the backward's B C^T of one (batch, group, chunk), rows j and columns i,
// whole, in the same order: rows 0-63 (64 registers a thread), then rows
// 64-127 (64)
constexpr int kSPFloats = (64 + 64) * 128;
// chunk pass: two boxes of B (and of C, or the f32 X tile), cumsum, tail
constexpr size_t kSmemChunk = 1024 + 2 * kBoxBytes + kL * kXS * 4 + 2 * kL * 4;
// output pass: X hi and lo, two boxes of C, two boxes each of h_in hi and lo
constexpr size_t kSmemOutput = 1024 + 4 * kBoxBytes + 4 * 64 * 128 + 2 * kL * 4;
static_assert(2 * kSmemOutput <= kMaxSmem, "two output blocks must fit an H100 SM");

struct Dims {
  int B, S, H, G, P, N;
  int nc;  // chunks of kL rows: ceil(S / kL)
  int np;  // boxes of 64 columns of P: ceil(P / 64)
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// a[r] = the sum of dA over rows 0..r of the chunk, rows past `rows` adding
// 0; by one warp: four rows a lane, then a shuffle scan of the lanes' sums
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dA, long long stride,
                                             int rows, float* a, int lane) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * lane + k;
    v[k] = r < rows ? dA[r * stride] : 0.f;
  }
  v[1] += v[0];
  v[2] += v[1];
  v[3] += v[2];
  float s = v[3];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) a[4 * lane + k] = before + v[k];
}

// a [kRows][64] bf16 box at `dst` (1024-byte aligned, swizzled by 128
// bytes) from src[r * stride + c] for r < rows, c < cols, zeros elsewhere,
// by kThr threads.  `vec`: 16-byte loads (src 16-byte aligned, stride and
// cols multiples of 8), all in flight before the first store.
template <int kRows, int kThr>
__device__ __forceinline__ void load_box(uint8_t* dst, const __nv_bfloat16* __restrict__ src,
                                         long long stride, int rows, int cols, bool vec,
                                         int tid) {
  constexpr int kIt = kRows * 8 / kThr;
  if (vec) {
    uint4 v[kIt];
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int i = tid + k * kThr, r = i >> 3, c = (i & 7) * 8;
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < cols) v[k] = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int i = tid + k * kThr;
      *reinterpret_cast<uint4*>(dst + sw128(i >> 3, (i & 7) * 8)) = v[k];
    }
  } else {
    for (int i = tid; i < kRows * 64; i += kThr) {
      const int r = i >> 6, c = i & 63;
      const __nv_bfloat16 v = r < rows && c < cols ? src[r * stride + c] : __float2bfloat16(0.f);
      *reinterpret_cast<__nv_bfloat16*>(dst + sw128(r, c)) = v;
    }
  }
}

// f32 values src[r * stride + c] (r < rows, c < cols, zeros elsewhere) split
// into two [kRows][64] bf16 boxes, hi = rn(v) and lo = rn(v - hi), by kThr
// threads.  `vec`: 16-byte loads (src 16-byte aligned, stride and cols
// multiples of 4), all in flight before the first store.
template <int kRows, int kThr>
__device__ __forceinline__ void load_split_box(uint8_t* hi, uint8_t* lo,
                                               const float* __restrict__ src, long long stride,
                                               int rows, int cols, bool vec, int tid) {
  constexpr int kIt = kRows * 8 / kThr;
  float v[kIt][8];
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int i = tid + k * kThr, r = i >> 3, c = (i & 7) * 8;
    if (vec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows && c + 4 * h < cols)
          f = *reinterpret_cast<const float4*>(src + r * stride + c + 4 * h);
        v[k][4 * h] = f.x;
        v[k][4 * h + 1] = f.y;
        v[k][4 * h + 2] = f.z;
        v[k][4 * h + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[k][e] = r < rows && c + e < cols ? src[r * stride + c + e] : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kIt; ++k) {
    const int i = tid + k * kThr;
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ph[e] = pack_bf16(v[k][2 * e], v[k][2 * e + 1]);
      pl[e] = pack_bf16(v[k][2 * e] - __uint_as_float(ph[e] << 16),
                        v[k][2 * e + 1] - __uint_as_float(ph[e] & 0xFFFF0000u));
    }
    const uint32_t off = sw128(i >> 3, (i & 7) * 8);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(ph[0], ph[1], ph[2], ph[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(pl[0], pl[1], pl[2], pl[3]);
  }
}

// v0, v1 split into bf16 pairs: hi = rn(v), lo = rn(v - hi)
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(v0 - __uint_as_float(hi << 16), v1 - __uint_as_float(hi & 0xFFFF0000u));
}

// block index -> (b, c, h, ps), heads of one chunk adjacent (their B and C
// tiles shared through L2)
struct ChunkHead {
  int b, c, h, ps;
  __device__ ChunkHead(int bid, const Dims& d)
      : b(bid / (d.np * d.H * d.nc)), c((bid / (d.np * d.H)) % d.nc), h((bid / d.np) % d.H),
        ps(bid % d.np) {}
};

// 1. the chunk pass, shared by the forward (kBwd false) and the backward
//    (kBwd true).  Blocks [0, B*nc*G): the scores R K^T of (b, g, c), the
//    heaviest, so first; then B*nc*H*np blocks the local states (V (.) w)^T
//    K of (b, c, h), rows p0 .. p0 + 63 of P.  The forward: R = C, K = B, V
//    = X, w = tail, its scores the lower triangle (rows 0-63 against
//    columns 0-63, rows 64-127 against all), and it writes the chunk
//    decays.  The backward: R = B, K = C, V = dY, w = exp(a), its scores the
//    upper triangle whole (two m64n128 halves; rows j, columns i), and no
//    local state of chunk 0 (it only reaches the initial state's
//    gradient).  One warpgroup a block; N in pairs of 64-column boxes, a
//    pair's products issued whole (a box past N is zeros), so no branch
//    splits a wgmma pipeline stage.
template <bool kBwd>
__device__ __forceinline__ void chunk_pass(const float* __restrict__ v, const float* __restrict__ dA,
                                           const __nv_bfloat16* __restrict__ R,
                                           const __nv_bfloat16* __restrict__ K,
                                           float* __restrict__ states, float* __restrict__ cb,
                                           float* __restrict__ cdecay, const Dims& d, int vec_x,
                                           int vec_bc) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Ks = base;                                      // [2][kL][64] boxes of K
  uint8_t* Rs = base + 2 * kBoxBytes;                      // [2][kL][64] boxes of R
  float* Vs = reinterpret_cast<float*>(Rs);                // [kL][kXS] V (over Rs)
  float* a = reinterpret_cast<float*>(Rs + kL * kXS * 4);  // [kL] cumsum of dA
  float* wt = a + kL;                                      // [kL] w
  constexpr int kLo = kBwd ? 64 : 32;                      // registers of rows 0-63
  constexpr int kHi = 64;                                  // and of rows 64-127

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, q = lane % 4;
  const int rA = 16 * warp + lane / 4, rB = rA + 8;  // this thread's accumulator rows
  const int n_cb = d.B * d.nc * d.G;
  const long long bc_stride = static_cast<long long>(d.G) * d.N;  // between rows of B, C

  if (static_cast<int>(blockIdx.x) < n_cb) {
    const int i = blockIdx.x;
    const int g = i % d.G, c = (i / d.G) % d.nc, b = i / (d.G * d.nc);
    const int rows = min(kL, d.S - c * kL);
    const long long off = ((static_cast<long long>(b) * d.S + c * kL) * d.G + g) * d.N;
    float acc0[kLo], acc1[kHi];
#pragma unroll
    for (int k = 0; k < kLo; ++k) acc0[k] = 0.f;
#pragma unroll
    for (int k = 0; k < kHi; ++k) acc1[k] = 0.f;
    for (int n0 = 0; n0 < d.N; n0 += 128) {
      if (n0) __syncthreads();  // the previous boxes are read
      for (int e = 0; e < 2; ++e) {
        const int cols = min(64, d.N - n0 - 64 * e);
        load_box<kL, 128>(Rs + e * kBoxBytes, R + off + n0 + 64 * e, bc_stride, rows, cols,
                          vec_bc, tid);
        load_box<kL, 128>(Ks + e * kBoxBytes, K + off + n0 + 64 * e, bc_stride, rows, cols,
                          vec_bc, tid);
      }
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int o = (t >> 2) * kBoxBytes + 32 * (t & 3);
        const uint64_t dk = smem_desc(Ks + o, 128, 16);
        wgmma_ss(acc0, smem_desc(Rs + o, 128, 16), dk, 1);
        wgmma_ss(acc1, smem_desc(Rs + o + 64 * 128, 128, 16), dk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
    }
    float4* out = reinterpret_cast<float4*>(
        cb + (static_cast<long long>(b * d.G + g) * d.nc + c) * (kBwd ? kSPFloats : kCBFloats));
#pragma unroll
    for (int k = 0; k < kLo / 4; ++k)
      out[k * 128 + tid] =
          make_float4(acc0[4 * k], acc0[4 * k + 1], acc0[4 * k + 2], acc0[4 * k + 3]);
#pragma unroll
    for (int k = 0; k < kHi / 4; ++k)
      out[(kLo / 4 + k) * 128 + tid] =
          make_float4(acc1[4 * k], acc1[4 * k + 1], acc1[4 * k + 2], acc1[4 * k + 3]);
    return;
  }

  // the local state of (b, c, h), rows p0 .. p0 + 63 of P
  const ChunkHead w(blockIdx.x - n_cb, d);
  if (kBwd && w.c == 0) return;
  const int g = w.h / (d.H / d.G);
  const int rows = min(kL, d.S - w.c * kL), p0 = 64 * w.ps, pv = min(64, d.P - p0);
  const long long row0 = static_cast<long long>(w.b) * d.S + w.c * kL;  // in (B*S)
  const __nv_bfloat16* ks = K + (row0 * d.G + g) * d.N;
  if (warp == 0) chunk_cumsum(dA + row0 * d.H + w.h, d.H, rows, a, lane);
  const float* vs = v + (row0 * d.H + w.h) * d.P + p0;
  const long long x_stride = static_cast<long long>(d.H) * d.P;
  if (vec_x) {
    constexpr int kIt = kL * 16 / 128;
    float4 u[kIt];
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int i = tid + 128 * k, r = i >> 4, c = (i & 15) * 4;
      u[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < pv) u[k] = *reinterpret_cast<const float4*>(vs + r * x_stride + c);
    }
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int i = tid + 128 * k;
      *reinterpret_cast<float4*>(Vs + (i >> 4) * kXS + (i & 15) * 4) = u[k];
    }
  } else {
    for (int i = tid; i < kL * 64; i += 128) {
      const int r = i >> 6, c = i & 63;
      Vs[r * kXS + c] = r < rows && c < pv ? vs[r * x_stride + c] : 0.f;
    }
  }
  // the first two boxes of K (the wgmma reads them after the barrier below)
  for (int e = 0; e < 2; ++e)
    load_box<kL, 128>(Ks + e * kBoxBytes, ks + 64 * e, bc_stride, rows, min(64, d.N - 64 * e),
                      vec_bc, tid);
  fence_proxy_async();
  __syncthreads();
  wt[tid] = kBwd ? expf(a[tid]) : expf(a[kL - 1] - a[tid]);  // 128 threads, kL rows
  if (!kBwd && tid == 0 && w.ps == 0)
    cdecay[(static_cast<long long>(w.b) * d.H + w.h) * d.nc + w.c] = expf(a[kL - 1]);
  __syncthreads();

  // A = (V (.) w)^T, rows p and depth j, split into bf16 hi + lo, in the
  // register-A layout: register jj of depth step kk holds rows rA (jj even)
  // or rB (odd), columns 16 kk + 8 (jj / 2) + 2 q and + 1.  Row stride kXS
  // puts a warp's 32 reads on 32 banks.
  uint32_t ahi[kL / 16][4], alo[kL / 16][4];
#pragma unroll
  for (int kk = 0; kk < kL / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int p = jj & 1 ? rB : rA, j = 16 * kk + 8 * (jj >> 1) + 2 * q;
      split_pair(Vs[j * kXS + p] * wt[j], Vs[(j + 1) * kXS + p] * wt[j + 1], ahi[kk][jj],
                 alo[kk][jj]);
    }

  // state[p][n] = sum_j A[p][j] K[j][n], two boxes of N at a time (K MN-major)
  float* st = states + ((static_cast<long long>(w.b * d.nc + w.c) * d.H + w.h) * d.P + p0) * d.N;
  for (int n0 = 0; n0 < d.N; n0 += 128) {
    if (n0) {
      __syncthreads();  // the previous boxes are read
      for (int e = 0; e < 2; ++e)
        load_box<kL, 128>(Ks + e * kBoxBytes, ks + n0 + 64 * e, bc_stride, rows,
                          min(64, d.N - n0 - 64 * e), vec_bc, tid);
      fence_proxy_async();
      __syncthreads();
    }
    float acc[2][32];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[e][k] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        const uint64_t db = smem_desc(Ks + e * kBoxBytes + kk * 16 * 128, 128, kL * 128);
        wgmma_rs(acc[e], ahi[kk], db);
        wgmma_rs(acc[e], alo[kk], db);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      fence_regs(ahi[kk]);
      fence_regs(alo[kk]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int p = (k >> 1) & 1 ? rB : rA;
        const int n = n0 + 64 * e + 8 * (k / 4) + (k & 1) + 2 * q;
        if (p < pv && n < d.N) st[p * d.N + n] = acc[e][k];
      }
  }
}

__global__ void __launch_bounds__(128)
ssd_scan_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                      const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                      float* __restrict__ states, float* __restrict__ cb,
                      float* __restrict__ cdecay, Dims d, int vec_x, int vec_bc) {
  chunk_pass<false>(x, dA, Cm, Bm, states, cb, cdecay, d, vec_x, vec_bc);
}

// 2. the state pass: one thread per (b, h, p, n), in order over the chunks;
//    each chunk's slot gets the state entering it, h the last state
__global__ void __launch_bounds__(256)
ssd_scan_state_kernel(float* __restrict__ states, const float* __restrict__ cdecay,
                      float* __restrict__ hout, Dims d) {
  const long long pn_count = static_cast<long long>(d.P) * d.N;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= d.B * d.H * pn_count) return;
  const long long bh = e / pn_count, pn = e % pn_count;
  const int b = static_cast<int>(bh / d.H), h = static_cast<int>(bh % d.H);
  const long long step = d.H * pn_count;  // from one chunk's state to the next
  float* st = states + (static_cast<long long>(b) * d.nc * d.H + h) * pn_count + pn;
  const float* dec = cdecay + bh * d.nc;
  float hv = st[0];  // the state after chunk 0 (entering it: 0)
  float next = d.nc > 1 ? st[step] : 0.f;
  for (int c = 1; c < d.nc; ++c) {
    const float s = next;
    if (c + 1 < d.nc) next = st[(c + 1) * step];  // loaded ahead of the recurrence
    st[c * step] = hv;
    hv = fmaf(hv, dec[c], s);
  }
  hout[e] = hv;
}

// + (C B^T (.) decay) X for a warpgroup whose rows iA, iB need depth steps
// 0 .. KS-1 (columns 0 .. 16 KS - 1 of the chunk): A built in registers from
// C B^T in fragment order (`cbf`: this thread's float4 0), the decay by
// select then exp, split into bf16 hi + lo; three products a step.  Step
// kk's A is built while step kk - 1's products run (two register buffers).
template <int KS>
__device__ __forceinline__ void intra_chunk(float (&acc)[32], const float4* __restrict__ cbf,
                                            const float* a, const uint8_t* Xhi,
                                            const uint8_t* Xlo, int iA, int iB, int q) {
  const float neg_inf = __int_as_float(0xff800000);
  const float aA = a[iA], aB = a[iB];
  uint32_t ahi[2][4] = {}, alo[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t(&hi4)[4] = ahi[kk & 1];
    uint32_t(&lo4)[4] = alo[kk & 1];
    const float4 u = cbf[(2 * kk) * 128], w = cbf[(2 * kk + 1) * 128];
    const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};  // registers 8 kk .. 8 kk + 7
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i = jj & 1 ? iB : iA, j = 16 * kk + 8 * (jj >> 1) + 2 * q;
      const float ai = jj & 1 ? aB : aA;
      const float d0 = i >= j ? ai - a[j] : neg_inf;  // select, then exp
      const float d1 = i >= j + 1 ? ai - a[j + 1] : neg_inf;
      const float m0 = v[2 * jj] * expf(d0), m1 = v[2 * jj + 1] * expf(d1);
      const uint32_t hi = pack_bf16(m0, m1);
      hi4[jj] = hi;
      lo4[jj] = pack_bf16(m0 - __uint_as_float(hi << 16), m1 - __uint_as_float(hi & 0xFFFF0000u));
    }
    wgmma_fence();
    const uint64_t dh = smem_desc(Xhi + kk * 16 * 128, 128, kL * 128);
    const uint64_t dl = smem_desc(Xlo + kk * 16 * 128, 128, kL * 128);
    wgmma_rs(acc, hi4, dh);
    wgmma_rs(acc, hi4, dl);
    wgmma_rs(acc, lo4, dh);
    wgmma_commit();
    // step kk - 1's products are done: its buffer may be rebuilt
    wgmma_wait<1>();
    fence_regs(ahi[(kk + 1) & 1]);
    fence_regs(alo[(kk + 1) & 1]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ahi[(KS - 1) & 1]);
  fence_regs(alo[(KS - 1) & 1]);
}

// 3. the output pass: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the
//    chunk; N in pairs of 64-column boxes
__global__ void __launch_bounds__(256, 2)
ssd_scan_output_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                       const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ states,
                       const float* __restrict__ cb, float* __restrict__ y, Dims d, int vec_x,
                       int vec_bc, int vec_h) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Xhi = base;                 // [kL][64] X hi, MN-major
  uint8_t* Xlo = Xhi + kBoxBytes;      // [kL][64] X lo
  uint8_t* Cs = Xlo + kBoxBytes;       // [2][kL][64] boxes of C, K-major
  uint8_t* Hhi = Cs + 2 * kBoxBytes;   // [2][64][64] boxes of h_in hi, K-major (rows p)
  uint8_t* Hlo = Hhi + 2 * 64 * 128;   // [2][64][64] h_in lo
  float* a = reinterpret_cast<float*>(Hlo + 2 * 64 * 128);  // [kL] cumsum of dA
  float* ea = a + kL;                                       // [kL] exp(a)

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int q = lane % 4, iA = 64 * wg + 16 * warp + lane / 4, iB = iA + 8;  // chunk rows
  const ChunkHead w(blockIdx.x, d);
  const int g = w.h / (d.H / d.G);
  const int rows = min(kL, d.S - w.c * kL), p0 = 64 * w.ps, pv = min(64, d.P - p0);
  const long long row0 = static_cast<long long>(w.b) * d.S + w.c * kL;  // in (B*S)
  const long long x_stride = static_cast<long long>(d.H) * d.P;
  const __nv_bfloat16* cs = Cm + (row0 * d.G + g) * d.N;
  const float* hin =
      states + ((static_cast<long long>(w.b * d.nc + w.c) * d.H + w.h) * d.P + p0) * d.N;
  // C and h_in boxes n0 and n0 + 64 (no state enters the first chunk)
  auto load_pair = [&](int n0) {
    for (int e = 0; e < 2; ++e) {
      const int cols = min(64, d.N - n0 - 64 * e);
      load_box<kL, 256>(Cs + e * kBoxBytes, cs + n0 + 64 * e, static_cast<long long>(d.G) * d.N,
                        rows, cols, vec_bc, tid);
      load_split_box<64, 256>(Hhi + e * 64 * 128, Hlo + e * 64 * 128, hin + n0 + 64 * e, d.N, pv,
                              cols, vec_h, tid);
    }
  };

  if (tid < 32) chunk_cumsum(dA + row0 * d.H + w.h, d.H, rows, a, lane);
  load_split_box<kL, 256>(Xhi, Xlo, x + (row0 * d.H + w.h) * d.P + p0, x_stride, rows, pv,
                          vec_x, tid);
  if (w.c > 0) load_pair(0);
  fence_proxy_async();
  __syncthreads();
  if (tid < kL) ea[tid] = expf(a[tid]);

  // exp(a) (.) (C h_in^T)
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  if (w.c > 0) {
    for (int n0 = 0; n0 < d.N; n0 += 128) {
      if (n0) {
        __syncthreads();  // the previous boxes are read
        load_pair(n0);
        fence_proxy_async();
        __syncthreads();
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {  // a box past N is zeros
        const int e = t >> 2, o = 32 * (t & 3);
        const uint64_t dc = smem_desc(Cs + e * kBoxBytes + 64 * wg * 128 + o, 128, 16);
        wgmma_ss(acc, dc, smem_desc(Hhi + e * 64 * 128 + o, 128, 16), 1);
        wgmma_ss(acc, dc, smem_desc(Hlo + e * 64 * 128 + o, 128, 16), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
  }
  __syncthreads();  // ea
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] *= ea[(k >> 1) & 1 ? iB : iA];

  // + (C B^T (.) decay) X: rows 0-63 need columns 0-63, rows 64-127 all
  const float4* cbf = reinterpret_cast<const float4*>(
                          cb + (static_cast<long long>(w.b * d.G + g) * d.nc + w.c) * kCBFloats) +
                      (wg ? 8 * 128 : 0) + tid % 128;
  if (wg == 0)
    intra_chunk<kL / 32>(acc, cbf, a, Xhi, Xlo, iA, iB, q);
  else
    intra_chunk<kL / 16>(acc, cbf, a, Xhi, Xlo, iA, iB, q);

  float* yo = y + (row0 * d.H + w.h) * d.P + p0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = (k >> 1) & 1 ? iB : iA, p = 8 * (k / 4) + (k & 1) + 2 * q;
    if (i < rows && p < pv) yo[i * x_stride + p] = acc[k];
  }
}

Dims dims_of(int B, int S, int H, int G, int P, int N) {
  return Dims{B, S, H, G, P, N, (S + kL - 1) / kL, (P + 63) / 64};
}

// the workspace: the chunk states (B, nc, H, P, N), C B^T (B, G, nc,
// kCBFloats), the chunk decays (B, H, nc), all f32
size_t workspace_floats(const Dims& d) {
  return static_cast<size_t>(d.B) * d.nc * d.H * d.P * d.N +
         static_cast<size_t>(d.B) * d.G * d.nc * kCBFloats + static_cast<size_t>(d.B) * d.H * d.nc;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

cudaError_t launch_bf16(const float* x, const float* dA, const void* Bm, const void* Cm, float* y,
                        float* h, void* workspace, int B, int S, int H, int G, int P, int N,
                        cudaStream_t stream) {
  const Dims d = dims_of(B, S, H, G, P, N);
  if (!aligned16(workspace)) return cudaErrorInvalidValue;
  float* states = static_cast<float*>(workspace);
  float* cb = states + static_cast<size_t>(B) * d.nc * H * P * N;
  float* cdecay = cb + static_cast<size_t>(B) * G * d.nc * kCBFloats;
  const auto* bm = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cm = static_cast<const __nv_bfloat16*>(Cm);
  const int vec_x = aligned16(x);
  const int vec_bc = N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  const int vec_h = N % 4 == 0;
  const long long n1 = static_cast<long long>(B) * d.nc * (G + static_cast<long long>(H) * d.np);
  const long long n2 = (static_cast<long long>(B) * H * P * N + 255) / 256;
  const long long n3 = static_cast<long long>(B) * d.nc * H * d.np;
  if (n1 > 0x7fffffffLL || n2 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemChunk));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_scan_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemOutput));
  if (err != cudaSuccess) return err;
  ssd_scan_chunk_kernel<<<static_cast<unsigned>(n1), 128, kSmemChunk, stream>>>(
      x, dA, bm, cm, states, cb, cdecay, d, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_state_kernel<<<static_cast<unsigned>(n2), 256, 0, stream>>>(states, cdecay, h, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_output_kernel<<<static_cast<unsigned>(n3), 256, kSmemOutput, stream>>>(
      x, dA, cm, states, cb, y, d, vec_x, vec_bc, vec_h);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward (bf16 B/C): the kernels ssd_bwd_*, five launches a call

constexpr int kPBoxBytes = 64 * 128;  // a [64][64] bf16 box (rows of P)
// dx pass: X and dY hi and lo, two boxes each of B and C, two boxes each of
// g and h_in hi and lo; a, exp(a), tail, the row terms, T's column sums by
// warp, the block's sum
constexpr size_t kSmemDx = 1024 + 8 * kBoxBytes + 8 * kPBoxBytes + (4 * kL + 8 * kL + 8) * 4;
// dB / dC pass: W and W^T hi and lo (two boxes each), then six boxes of
// operands
constexpr size_t kSmemDbc = 1024 + 14 * kBoxBytes + 2 * kL * 4;
static_assert(kSmemDx <= kMaxSmem && kSmemDbc <= kMaxSmem, "the backward's blocks fit an SM");
constexpr int kDbcBlocks = 264;  // the dB / dC pass splits a group's heads to reach two waves

__global__ void __launch_bounds__(128)
ssd_bwd_chunk_kernel(const float* __restrict__ dy, const float* __restrict__ dA,
                     const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                     float* __restrict__ gs, float* __restrict__ sp, Dims d, int vec_x,
                     int vec_bc) {
  chunk_pass<true>(dy, dA, Bm, Cm, gs, sp, nullptr, d, vec_x, vec_bc);
}

// the reverse state pass: one thread per (b, h, p, n), from the last chunk
// to the first, g_{c-1} = exp(a_c[L-1]) g_c + dstate_c from g_{nc-1} = gh
// (or 0); each chunk's slot, which held its dstate, gets g_c, the gradient
// of the state leaving the chunk
__global__ void __launch_bounds__(256)
ssd_bwd_state_kernel(float* __restrict__ gs, const float* __restrict__ cdecay,
                     const float* __restrict__ gh, Dims d) {
  const long long pn_count = static_cast<long long>(d.P) * d.N;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= d.B * d.H * pn_count) return;
  const long long bh = e / pn_count, pn = e % pn_count;
  const int b = static_cast<int>(bh / d.H), h = static_cast<int>(bh % d.H);
  const long long step = d.H * pn_count;  // from one chunk's slot to the next
  float* st = gs + (static_cast<long long>(b) * d.nc * d.H + h) * pn_count + pn;
  const float* dec = cdecay + bh * d.nc;
  float gv = gh ? gh[e] : 0.f;
  float next = d.nc > 1 ? st[(d.nc - 1) * step] : 0.f;
  for (int c = d.nc - 1; c > 0; --c) {
    const float s = next;
    if (c > 1) next = st[(c - 1) * step];  // loaded ahead of the recurrence
    st[c * step] = gv;
    gv = fmaf(gv, dec[c], s);
  }
  st[0] = gv;
}

// 64 accumulator registers of rows j (this thread's jA, jB) and columns i of
// a chunk: D^T = X dY^T over one box of P, both split: hi.hi + hi.lo + lo.hi
__device__ __forceinline__ void xdy_products(float (&acc)[64], const uint8_t* Xhi,
                                             const uint8_t* Xlo, const uint8_t* Yhi,
                                             const uint8_t* Ylo, int wg) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint64_t xh = smem_desc(Xhi + 64 * wg * 128 + 32 * t, 128, 16);
    const uint64_t xl = smem_desc(Xlo + 64 * wg * 128 + 32 * t, 128, 16);
    const uint64_t yh = smem_desc(Yhi + 32 * t, 128, 16);
    wgmma_ss(acc, xh, yh, 1);
    wgmma_ss(acc, xh, smem_desc(Ylo + 32 * t, 128, 16), 1);
    wgmma_ss(acc, xl, yh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// dX and ddA of (b, c, h), two warpgroups: warpgroup wg owns rows j = 64 wg
// .. 64 wg + 63 of the chunk against every column i (the masked triangle is
// a select to 0).
//   dX   = tail (.) (B g^T) + M^T dY,  M^T[j][i] = (B_j . C_i) exp(a_i - a_j), i >= j
//   da_k = sum_j T[k][j] - sum_i T[i][k] + exp(a_k) dy_k . (C h_in^T)_k
//          - x_k . dxs_k + [k = L-1] (sum_j x_j . dxs_j + exp(a[L-1]) <g, h_in>)
// with T = D (.) M, D[i][j] = dy_i . x_j, dxs = tail (.) (B g^T) the state's
// part of dX; ddA is da's reverse cumsum over the chunk.
__global__ void __launch_bounds__(256, 1)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                  const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                  const float* __restrict__ dy, const float* __restrict__ hs,
                  const float* __restrict__ gs, const float* __restrict__ sp,
                  const float* __restrict__ cdecay, float* __restrict__ dx,
                  float* __restrict__ ddA, Dims d, int vec_x, int vec_bc, int vec_h) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Xhi = base;                  // [kL][64] X, rows j (K-major A of X dY^T)
  uint8_t* Xlo = Xhi + kBoxBytes;
  uint8_t* Yhi = Xlo + kBoxBytes;       // [kL][64] dY, rows i (K-major B of X dY^T,
  uint8_t* Ylo = Yhi + kBoxBytes;       // MN-major B of M^T dY)
  uint8_t* Bs = Ylo + kBoxBytes;        // [2][kL][64] boxes of B
  uint8_t* Cs = Bs + 2 * kBoxBytes;     // [2][kL][64] boxes of C
  uint8_t* Ghi = Cs + 2 * kBoxBytes;    // [2][64][64] g, rows p
  uint8_t* Glo = Ghi + 2 * kPBoxBytes;
  uint8_t* Hhi = Glo + 2 * kPBoxBytes;  // [2][64][64] h_in, rows p
  uint8_t* Hlo = Hhi + 2 * kPBoxBytes;
  float* a = reinterpret_cast<float*>(Hlo + 2 * kPBoxBytes);  // [kL] cumsum of dA
  float* ea = a + kL;                                          // [kL] exp(a)
  float* tail = ea + kL;                                       // [kL] exp(a[kL-1] - a)
  float* rowv = tail + kL;                                     // [kL] da's row terms
  float* colp = rowv + kL;                                     // [8][kL] T's column sums
  float* red = colp + 8 * kL;                                  // [8] by warp

  const int tid = threadIdx.x, wg = tid / 128, wid = tid / 32, lane = tid % 32, q = lane % 4;
  const int jA = 64 * wg + 16 * (wid % 4) + lane / 4, jB = jA + 8;  // this thread's rows
  const int h = blockIdx.x % d.H, c = (blockIdx.x / d.H) % d.nc, b = blockIdx.x / (d.H * d.nc);
  const int g = h / (d.H / d.G);
  const int rows = min(kL, d.S - c * kL);
  const long long row0 = static_cast<long long>(b) * d.S + c * kL;  // in (B*S)
  const long long x_stride = static_cast<long long>(d.H) * d.P;
  const long long bc_stride = static_cast<long long>(d.G) * d.N;
  const long long pn = static_cast<long long>(d.P) * d.N;
  const long long slot = (static_cast<long long>(b * d.nc + c) * d.H + h) * pn;  // (b, c, h)'s state
  const float* xs = x + (row0 * d.H + h) * d.P;
  const float* ys = dy + (row0 * d.H + h) * d.P;
  const __nv_bfloat16* bs = Bm + (row0 * d.G + g) * d.N;
  const __nv_bfloat16* cs = Cm + (row0 * d.G + g) * d.N;
  const float neg_inf = __int_as_float(0xff800000);

  auto load_xy = [&](int ps, bool with_x) {
    const int pv = min(64, d.P - 64 * ps);
    if (with_x) load_split_box<kL, 256>(Xhi, Xlo, xs + 64 * ps, x_stride, rows, pv, vec_x, tid);
    load_split_box<kL, 256>(Yhi, Ylo, ys + 64 * ps, x_stride, rows, pv, vec_x, tid);
  };
  // boxes n0 and n0 + 64 of B and C, and of g and h_in at rows 64 ps .. of P
  // (no state enters the first chunk)
  auto load_state = [&](int ps, int n0) {
    const int pv = min(64, d.P - 64 * ps);
    for (int e = 0; e < 2; ++e) {
      const int cols = min(64, d.N - n0 - 64 * e);
      const long long o = slot + 64LL * ps * d.N + n0 + 64 * e;
      load_box<kL, 256>(Bs + e * kBoxBytes, bs + n0 + 64 * e, bc_stride, rows, cols, vec_bc, tid);
      load_box<kL, 256>(Cs + e * kBoxBytes, cs + n0 + 64 * e, bc_stride, rows, cols, vec_bc, tid);
      load_split_box<64, 256>(Ghi + e * kPBoxBytes, Glo + e * kPBoxBytes, gs + o, d.N, pv, cols,
                              vec_h, tid);
      if (c > 0)
        load_split_box<64, 256>(Hhi + e * kPBoxBytes, Hlo + e * kPBoxBytes, hs + o, d.N, pv,
                                cols, vec_h, tid);
    }
  };

  if (tid < 32) chunk_cumsum(dA + row0 * d.H + h, d.H, rows, a, lane);
  load_xy(0, true);
  load_state(0, 0);
  fence_proxy_async();
  __syncthreads();
  if (tid < kL) {
    ea[tid] = expf(a[tid]);
    tail[tid] = expf(a[kL - 1] - a[tid]);
  }

  // 1. D^T = X dY^T, over the boxes of P
  float dt[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) dt[k] = 0.f;
  for (int ps = 0; ps < d.np; ++ps) {
    if (ps) {
      __syncthreads();  // the previous boxes are read
      load_xy(ps, true);
      fence_proxy_async();
      __syncthreads();
    }
    xdy_products(dt, Xhi, Xlo, Yhi, Ylo, wg);
  }
  __syncthreads();  // ea, tail

  // 2. per box of P: dX, and with the first box T's sums
  float rt[2] = {0.f, 0.f};  // rows jA, jB: this thread's part of da's row terms
  float last = 0.f;          // this thread's part of sum_j x_j . dxs_j
  const float4* spf =
      reinterpret_cast<const float4*>(sp + (static_cast<long long>(b * d.G + g) * d.nc + c) *
                                               kSPFloats) + wg * 16 * 128 + tid % 128;
  const float aA = a[jA], aB = a[jB];
  for (int ps = 0; ps < d.np; ++ps) {
    const int p0 = 64 * ps, pv = min(64, d.P - p0);
    float acc[32], z[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = z[k] = 0.f;
    // B g^T and C h_in^T (rows j, columns p), two boxes of N at a time
    for (int n0 = 0; n0 < d.N; n0 += 128) {
      const bool fresh = ps == 0 && n0 == 0;  // loaded above
      if (!fresh || d.np > 1) {
        __syncthreads();  // the previous boxes are read
        if (!fresh) load_state(ps, n0);
        if (n0 == 0 && d.np > 1) load_xy(ps, false);
        fence_proxy_async();
        __syncthreads();
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t) {  // a box past N is zeros
        const int e = t >> 2, o = 32 * (t & 3);
        const uint64_t db = smem_desc(Bs + e * kBoxBytes + 64 * wg * 128 + o, 128, 16);
        wgmma_ss(acc, db, smem_desc(Ghi + e * kPBoxBytes + o, 128, 16), 1);
        wgmma_ss(acc, db, smem_desc(Glo + e * kPBoxBytes + o, 128, 16), 1);
        if (c > 0) {
          const uint64_t dc = smem_desc(Cs + e * kBoxBytes + 64 * wg * 128 + o, 128, 16);
          wgmma_ss(z, dc, smem_desc(Hhi + e * kPBoxBytes + o, 128, 16), 1);
          wgmma_ss(z, dc, smem_desc(Hlo + e * kPBoxBytes + o, 128, 16), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(z);
    }
    // dxs = tail (.) B g^T starts dX; the row terms from x, dy in f32
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int j = (k >> 1) & 1 ? jB : jA, p = 8 * (k / 4) + 2 * q;
      acc[k] *= tail[j];
      acc[k + 1] *= tail[j];
      if (j < rows && p < pv) {
        const long long o = j * x_stride + p0 + p;
        const float xd = xs[o] * acc[k] + xs[o + 1] * acc[k + 1];
        rt[(k >> 1) & 1] += ea[j] * (ys[o] * z[k] + ys[o + 1] * z[k + 1]) - xd;
        last += xd;
      }
    }
    // + M^T dY: A built in registers from S' a depth step at a time, the
    // decay by select then exp, split into bf16 hi + lo; three products a
    // step, step kk's A built while step kk - 1's products run
    uint32_t ahi[2][4] = {}, alo[2][4] = {};
    float rowT[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      uint32_t(&hi4)[4] = ahi[kk & 1];
      uint32_t(&lo4)[4] = alo[kk & 1];
      const float4 u = spf[(2 * kk) * 128], w = spf[(2 * kk + 1) * 128];
      const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};  // registers 8 kk .. 8 kk + 7
      float col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = jj & 1 ? jB : jA, i = 16 * kk + 8 * (jj >> 1) + 2 * q;
        const float aj = jj & 1 ? aB : aA;
        const float m0 = v[2 * jj] * expf(i >= j ? a[i] - aj : neg_inf);  // select, then exp
        const float m1 = v[2 * jj + 1] * expf(i + 1 >= j ? a[i + 1] - aj : neg_inf);
        split_pair(m0, m1, hi4[jj], lo4[jj]);
        const float t0 = dt[8 * kk + 2 * jj] * m0, t1 = dt[8 * kk + 2 * jj + 1] * m1;
        rowT[jj & 1] += t0 + t1;
        col[2 * (jj >> 1)] += t0;
        col[2 * (jj >> 1) + 1] += t1;
      }
      wgmma_fence();
      const uint64_t dh = smem_desc(Yhi + kk * 16 * 128, 128, kL * 128);
      const uint64_t dl = smem_desc(Ylo + kk * 16 * 128, 128, kL * 128);
      wgmma_rs(acc, hi4, dh);
      wgmma_rs(acc, hi4, dl);
      wgmma_rs(acc, lo4, dh);
      wgmma_commit();
      if (ps == 0) {  // T's column sums over this warp's 16 rows
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) col[m] += __shfl_xor_sync(0xffffffffu, col[m], o);
        if (lane < 4) {
          float* cp = colp + wid * kL + 16 * kk + 2 * lane;
          cp[0] = col[0];
          cp[1] = col[1];
          cp[8] = col[2];
          cp[9] = col[3];
        }
      }
      // step kk - 1's products are done: its buffer may be rebuilt
      wgmma_wait<1>();
      fence_regs(ahi[(kk + 1) & 1]);
      fence_regs(alo[(kk + 1) & 1]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ahi[1]);
    fence_regs(alo[1]);
    if (ps == 0) {
      rt[0] -= rowT[0];
      rt[1] -= rowT[1];
    }
    float* dxo = dx + (row0 * d.H + h) * d.P + p0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int j = (k >> 1) & 1 ? jB : jA, p = 8 * (k / 4) + (k & 1) + 2 * q;
      if (j < rows && p < pv) dxo[j * x_stride + p] = acc[k];
    }
  }

  // 3. da by row, then ddA, its reverse cumsum over the chunk (one warp)
  float dot = 0.f;  // this thread's part of <g, h_in>
  if (c > 0)
    for (long long e = tid; e < pn; e += 256) dot = fmaf(gs[slot + e], hs[slot + e], dot);
  float tot = fmaf(cdecay[(static_cast<long long>(b) * d.H + h) * d.nc + c], dot, last);
#pragma unroll
  for (int o = 16; o; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rt[r] += __shfl_xor_sync(0xffffffffu, rt[r], 1);
    rt[r] += __shfl_xor_sync(0xffffffffu, rt[r], 2);
  }
  if (q == 0) {
    rowv[jA] = rt[0];
    rowv[jB] = rt[1];
  }
  if (lane == 0) red[wid] = tot;
  __syncthreads();
  if (tid < 32) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * lane + e;
      float s = rowv[k];
#pragma unroll
      for (int w = 0; w < 8; ++w) s += colp[w * kL + k];
      v[e] = s;
    }
    if (lane == 31) {
#pragma unroll
      for (int w = 0; w < 8; ++w) v[3] += red[w];
    }
    v[2] += v[3];
    v[1] += v[2];
    v[0] += v[1];
    float s = v[0];  // the suffix sum of the lanes' totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, s, o);
      if (lane + o < 32) s += t;
    }
    float after = __shfl_down_sync(0xffffffffu, s, 1);
    if (lane == 31) after = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * lane + e;
      if (k < rows) ddA[(row0 + k) * d.H + h] = after + v[e];
    }
  }
}

// dB and dC of (b, c, g) over split s of the group's heads, two warpgroups
// of 64 rows: W^T = sum_h D^T_h (.) L^T_h (L^T[j][i] = exp(a_i - a_j), i >=
// j) in registers, rows j, then in shared memory as W^T and W, split; then
//   dB = W^T C + sum_h tail_h (.) (X_h g_h)      (rows j)
//   dC = W B + sum_h exp(a_h) (.) (dY_h h_in_h)  (rows i)
// each of the split's sums written as an f32 partial, summed in order over
// the splits by the reduce pass.  The row scales come after the products,
// in f32, so X, g, dY and h_in are split as they are.
__global__ void __launch_bounds__(256, 1)
ssd_bwd_dbc_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                   const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
                   const float* __restrict__ dy, const float* __restrict__ hs,
                   const float* __restrict__ gs, float* __restrict__ part, Dims d, int nsplit,
                   int vec_x, int vec_bc, int vec_h) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* Vhi = base;                     // [2][kL][64] W^T, rows j, boxes of columns i
  uint8_t* Vlo = Vhi + 2 * kBoxBytes;
  uint8_t* Whi = Vlo + 2 * kBoxBytes;      // [2][kL][64] W, rows i, boxes of columns j
  uint8_t* Wlo = Whi + 2 * kBoxBytes;
  uint8_t* op = Wlo + 2 * kBoxBytes;       // the operands, by phase:
  uint8_t* Xhi = op;                       // 1: X and dY hi and lo (as the dx pass)
  uint8_t* Xlo = op + kBoxBytes;
  uint8_t* Yhi = op + 2 * kBoxBytes;
  uint8_t* Ylo = op + 3 * kBoxBytes;
  uint8_t* Ks = op;                        // 2: [2][kL][64] C or B (MN-major B),
  uint8_t* Ahi = op + 2 * kBoxBytes;       // X or dY hi and lo (K-major A),
  uint8_t* Alo = op + 3 * kBoxBytes;
  uint8_t* Rhi = op + 4 * kBoxBytes;       // [2][64][64] g or h_in hi and lo (MN-major B)
  uint8_t* Rlo = Rhi + 2 * kPBoxBytes;
  float* a = reinterpret_cast<float*>(op + 6 * kBoxBytes);  // [kL] cumsum of dA
  float* sc = a + kL;                                       // [kL] tail or exp(a)

  const int tid = threadIdx.x, wg = tid / 128, wid = tid / 32, lane = tid % 32, q = lane % 4;
  const int jA = 64 * wg + 16 * (wid % 4) + lane / 4, jB = jA + 8;  // this thread's rows
  const int s = blockIdx.x % nsplit, g = (blockIdx.x / nsplit) % d.G;
  const int c = (blockIdx.x / (nsplit * d.G)) % d.nc, b = blockIdx.x / (nsplit * d.G * d.nc);
  const int hps = d.H / d.G / nsplit, h0 = g * (d.H / d.G) + s * hps;
  const int rows = min(kL, d.S - c * kL);
  const long long row0 = static_cast<long long>(b) * d.S + c * kL;  // in (B*S)
  const long long x_stride = static_cast<long long>(d.H) * d.P;
  const long long bc_stride = static_cast<long long>(d.G) * d.N;
  const long long pn = static_cast<long long>(d.P) * d.N;
  const float neg_inf = __int_as_float(0xff800000);

  // a of head h by warp 0, and its row scale: 1 the tail, 2 exp(a)
  auto cumsum = [&](int h, int scale) {
    if (wid != 0) return;
    chunk_cumsum(dA + row0 * d.H + h, d.H, rows, a, lane);
    if (!scale) return;
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * lane + e;
      sc[r] = scale == 1 ? expf(a[kL - 1] - a[r]) : expf(a[r]);
    }
  };

  // 1. W^T, rows j and columns i
  float w[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) w[k] = 0.f;
  for (int t = 0; t < hps; ++t) {
    const int h = h0 + t;
    float dt[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) dt[k] = 0.f;
    for (int ps = 0; ps < d.np; ++ps) {
      const int pv = min(64, d.P - 64 * ps);
      __syncthreads();  // the previous boxes and a are read
      if (ps == 0) cumsum(h, 0);
      const long long o = (row0 * d.H + h) * d.P + 64 * ps;
      load_split_box<kL, 256>(Xhi, Xlo, x + o, x_stride, rows, pv, vec_x, tid);
      load_split_box<kL, 256>(Yhi, Ylo, dy + o, x_stride, rows, pv, vec_x, tid);
      fence_proxy_async();
      __syncthreads();
      xdy_products(dt, Xhi, Xlo, Yhi, Ylo, wg);
    }
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      const int j = (k >> 1) & 1 ? jB : jA, i = 8 * (k / 4) + (k & 1) + 2 * q;
      w[k] = fmaf(dt[k], expf(i >= j ? a[i] - a[j] : neg_inf), w[k]);  // select, then exp
    }
  }
  // W^T (rows j) and W (rows i), split into bf16 hi + lo, as K-major A operands
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    const int j = (k >> 1) & 1 ? jB : jA, i = 8 * (k / 4) + (k & 1) + 2 * q;
    const __nv_bfloat16 hi = __float2bfloat16_rn(w[k]);
    const __nv_bfloat16 lo = __float2bfloat16_rn(w[k] - __bfloat162float(hi));
    const uint32_t ot = (i >> 6) * kBoxBytes + sw128(j, i & 63);
    const uint32_t ow = (j >> 6) * kBoxBytes + sw128(i, j & 63);
    *reinterpret_cast<__nv_bfloat16*>(Vhi + ot) = hi;
    *reinterpret_cast<__nv_bfloat16*>(Vlo + ot) = lo;
    *reinterpret_cast<__nv_bfloat16*>(Whi + ow) = hi;
    *reinterpret_cast<__nv_bfloat16*>(Wlo + ow) = lo;
  }
  fence_proxy_async();

  // 2. dB (which 0: W^T C, A X, R g, the tail) and dC (which 1: W B, A dY,
  //    R h_in, exp(a); no state enters the first chunk), two boxes of N at
  //    a time
  for (int which = 0; which < 2; ++which) {
    const __nv_bfloat16* ks = (which ? Bm : Cm) + (row0 * d.G + g) * d.N;
    const uint8_t* Mhi = which ? Whi : Vhi;
    const uint8_t* Mlo = which ? Wlo : Vlo;
    const float* av = which ? dy : x;
    const float* rv = which ? hs : gs;
    float* out = part + ((((static_cast<long long>(b) * d.nc + c) * nsplit + s) * d.G + g) * 2 +
                         which) * kL * d.N;
    for (int n0 = 0; n0 < d.N; n0 += 128) {
      float acc[2][32];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[e][k] = 0.f;
      __syncthreads();  // the previous boxes are read
      for (int e = 0; e < 2; ++e)
        load_box<kL, 256>(Ks + e * kBoxBytes, ks + n0 + 64 * e, bc_stride, rows,
                          min(64, d.N - n0 - 64 * e), vec_bc, tid);
      fence_proxy_async();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        const int o = (kk >> 2) * kBoxBytes + 64 * wg * 128 + 32 * (kk & 3);
        const uint64_t mh = smem_desc(Mhi + o, 128, 16), ml = smem_desc(Mlo + o, 128, 16);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint64_t dk = smem_desc(Ks + e * kBoxBytes + kk * 16 * 128, 128, kL * 128);
          wgmma_ss<1>(acc[e], mh, dk, 1);
          wgmma_ss<1>(acc[e], ml, dk, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      // + sum_h scale_h (.) (A_h R_h) over the split's heads
      for (int t = 0; t < (which && c == 0 ? 0 : hps); ++t) {
        const int h = h0 + t;
        float ah[2][32];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int k = 0; k < 32; ++k) ah[e][k] = 0.f;
        for (int ps = 0; ps < d.np; ++ps) {
          const int pv = min(64, d.P - 64 * ps);
          __syncthreads();  // the previous boxes and scales are read
          if (ps == 0) cumsum(h, which ? 2 : 1);
          load_split_box<kL, 256>(Ahi, Alo, av + (row0 * d.H + h) * d.P + 64 * ps, x_stride,
                                  rows, pv, vec_x, tid);
          const long long o =
              (static_cast<long long>(b * d.nc + c) * d.H + h) * pn + 64LL * ps * d.N + n0;
          for (int e = 0; e < 2; ++e)
            load_split_box<64, 256>(Rhi + e * kPBoxBytes, Rlo + e * kPBoxBytes, rv + o + 64 * e,
                                    d.N, pv, min(64, d.N - n0 - 64 * e), vec_h, tid);
          fence_proxy_async();
          __syncthreads();
          wgmma_fence();
#pragma unroll
          for (int t4 = 0; t4 < 4; ++t4) {
            const uint64_t dh = smem_desc(Ahi + 64 * wg * 128 + 32 * t4, 128, 16);
            const uint64_t dl = smem_desc(Alo + 64 * wg * 128 + 32 * t4, 128, 16);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ro = e * kPBoxBytes + t4 * 16 * 128;
              const uint64_t rh = smem_desc(Rhi + ro, 128, 64 * 128);
              wgmma_ss<1>(ah[e], dh, rh, 1);
              wgmma_ss<1>(ah[e], dh, smem_desc(Rlo + ro, 128, 64 * 128), 1);
              wgmma_ss<1>(ah[e], dl, rh, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(ah[0]);
          fence_regs(ah[1]);
        }
        const float sA = sc[jA], sB = sc[jB];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int k = 0; k < 32; ++k) acc[e][k] = fmaf((k >> 1) & 1 ? sB : sA, ah[e][k], acc[e][k]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int r = (k >> 1) & 1 ? jB : jA, n = n0 + 64 * e + 8 * (k / 4) + (k & 1) + 2 * q;
          if (n < d.N) out[r * d.N + n] = acc[e][k];
        }
    }
  }
}

// dB and dC: the splits' partials summed in order, rounded once to bf16;
// one thread per element of (B, S, G, N), dB's then dC's
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dB,
                      __nv_bfloat16* __restrict__ dC, Dims d, int nsplit) {
  const long long per = static_cast<long long>(d.B) * d.S * d.G * d.N;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= 2 * per) return;
  const int which = e >= per;
  const long long f = e - which * per;
  const int n = static_cast<int>(f % d.N), g = static_cast<int>((f / d.N) % d.G);
  const long long bsr = f / (static_cast<long long>(d.N) * d.G);  // b * S + row
  const int b = static_cast<int>(bsr / d.S), r = static_cast<int>(bsr % d.S);
  const long long stride = static_cast<long long>(d.G) * 2 * kL * d.N;  // between splits
  const float* src = part + ((static_cast<long long>(b) * d.nc + r / kL) * nsplit * d.G + g) *
                                2 * kL * d.N + (which * kL + r % kL) * static_cast<long long>(d.N) + n;
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) sum += src[s * stride];
  (which ? dC : dB)[f] = __float2bfloat16_rn(sum);
}

// the heads of a group are split so that the dB / dC pass has two waves of
// blocks, where the group has enough heads
int nsplit_of(const Dims& d) {
  const int rep = d.H / d.G;
  const long long blocks = static_cast<long long>(d.B) * d.nc * d.G;
  for (int s = 1; s < rep; ++s)
    if (rep % s == 0 && blocks * s >= kDbcBlocks) return s;
  return rep;
}

// the backward's workspace: g by chunk (B, nc, H, P, N), B C^T (B, G, nc,
// kSPFloats), the dB / dC partials (B, nc, nsplit, G, 2, kL, N), all f32
size_t bwd_workspace_floats(const Dims& d) {
  return static_cast<size_t>(d.B) * d.nc * d.H * d.P * d.N +
         static_cast<size_t>(d.B) * d.G * d.nc * kSPFloats +
         static_cast<size_t>(d.B) * d.nc * nsplit_of(d) * d.G * 2 * kL * d.N;
}

cudaError_t launch_bwd(const float* x, const float* dA, const void* Bm, const void* Cm,
                       const float* dy, const float* gh, const void* fwd_ws, float* dx,
                       float* ddA, void* dB, void* dC, void* workspace, int B, int S, int H, int G,
                       int P, int N, cudaStream_t stream) {
  const Dims d = dims_of(B, S, H, G, P, N);
  if (!aligned16(workspace) || !aligned16(fwd_ws)) return cudaErrorInvalidValue;
  const size_t n_states = static_cast<size_t>(B) * d.nc * H * P * N;
  const float* hs = static_cast<const float*>(fwd_ws);  // the forward's: h_in by chunk
  const float* cdecay = hs + n_states + static_cast<size_t>(B) * G * d.nc * kCBFloats;
  float* gs = static_cast<float*>(workspace);
  float* sp = gs + n_states;
  float* part = sp + static_cast<size_t>(B) * G * d.nc * kSPFloats;
  const int nsplit = nsplit_of(d);
  const auto* bm = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cm = static_cast<const __nv_bfloat16*>(Cm);
  const int vec_x = aligned16(x) && aligned16(dy);
  const int vec_bc = N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  const int vec_h = N % 4 == 0;
  const long long n1 = static_cast<long long>(B) * d.nc * (G + static_cast<long long>(H) * d.np);
  const long long n2 = (static_cast<long long>(B) * H * P * N + 255) / 256;
  const long long n3 = static_cast<long long>(B) * d.nc * H;
  const long long n4 = static_cast<long long>(B) * d.nc * G * nsplit;
  const long long n5 = (2LL * B * S * G * N + 255) / 256;
  if (n1 > 0x7fffffffLL || n2 > 0x7fffffffLL || n3 > 0x7fffffffLL || n4 > 0x7fffffffLL ||
      n5 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemChunk));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemDx));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_dbc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemDbc));
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<<<static_cast<unsigned>(n1), 128, kSmemChunk, stream>>>(
      dy, dA, bm, cm, gs, sp, d, vec_x, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_state_kernel<<<static_cast<unsigned>(n2), 256, 0, stream>>>(gs, cdecay, gh, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dx_kernel<<<static_cast<unsigned>(n3), 256, kSmemDx, stream>>>(
      x, dA, bm, cm, dy, hs, gs, sp, cdecay, dx, ddA, d, vec_x, vec_bc, vec_h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dbc_kernel<<<static_cast<unsigned>(n4), 256, kSmemDbc, stream>>>(
      x, dA, bm, cm, dy, hs, gs, part, d, nsplit, vec_x, vec_bc, vec_h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>(n5), 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC), d, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace ssd_scan_launch needs for these shapes and B/C
// dtype code (0 for f32 B/C).
long long ssd_scan_workspace_bytes(int B, int S, int H, int G, int P, int N, int bc_code) {
  if (bc_code != kBF16 || B < 1 || S < 1 || H < 1 || G < 1 || P < 1 || N < 1) return 0;
  return static_cast<long long>(workspace_floats(dims_of(B, S, H, G, P, N)) * sizeof(float));
}

// x (B,S,H,P) f32, dA (B,S,H) f32, Bm / Cm (B,S,G,N) of dtype bc_code, all
// contiguous -> y (B,S,H,P) f32, h (B,H,P,N) f32.  P must be a multiple of
// 8 and H of G.  bf16 B/C runs the tensor-core kernel (three launches) in
// `workspace` (16-byte aligned, ssd_scan_workspace_bytes), f32 the CUDA-core
// kernel (one launch).  Returns the first cudaError_t of the launches (0 on
// success).
int ssd_scan_launch(const void* x, const void* dA, const void* Bm, const void* Cm, void* y,
                    void* h, void* workspace, int B, int S, int H, int G, int P, int N,
                    int bc_code, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || P < 1 || N < 1 || H % G != 0 || P % 8 != 0)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(dA);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_code == kF32) return launch_f32(xf, af, Bm, Cm, yf, hf, B, S, H, G, P, N, s);
  if (bc_code == kBF16)
    return launch_bf16(xf, af, Bm, Cm, yf, hf, workspace, B, S, H, G, P, N, s);
  return cudaErrorInvalidValue;
}

// Bytes of the workspace ssd_scan_bwd_launch needs for these shapes.
long long ssd_scan_bwd_workspace_bytes(int B, int S, int H, int G, int P, int N) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || P < 1 || N < 1 || H % G != 0) return 0;
  return static_cast<long long>(bwd_workspace_floats(dims_of(B, S, H, G, P, N)) * sizeof(float));
}

// The gradients of a bf16-B/C ssd_scan_launch: x, dA, Bm, Cm as it took
// them, its workspace `fwd_ws` as it left it (the states entering each
// chunk, the chunk decays), dy (B,S,H,P) f32 and gh (B,H,P,N) f32 or null
// (no gradient of h), all contiguous -> dx (B,S,H,P) f32, ddA (B,S,H) f32,
// dB and dC (B,S,G,N) bf16, in `workspace` (16-byte aligned,
// ssd_scan_bwd_workspace_bytes).  Five launches; returns the first
// cudaError_t of the launches (0 on success).
int ssd_scan_bwd_launch(const void* x, const void* dA, const void* Bm, const void* Cm,
                        const void* dy, const void* gh, const void* fwd_ws, void* dx, void* ddA,
                        void* dB, void* dC, void* workspace, int B, int S, int H, int G, int P,
                        int N, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || P < 1 || N < 1 || H % G != 0 || P % 8 != 0)
    return cudaErrorInvalidValue;
  return launch_bwd(static_cast<const float*>(x), static_cast<const float*>(dA), Bm, Cm,
                    static_cast<const float*>(dy), static_cast<const float*>(gh), fwd_ws,
                    static_cast<float*>(dx), static_cast<float*>(ddA), dB, dC, workspace, B, S, H,
                    G, P, N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
