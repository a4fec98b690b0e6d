// flash_attention: online-softmax attention, forward only, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:93
// flash_attention_pallas (pallas_call body _flash_kernel, :32-86).  For
// q (B,S,H,hd) and k, v (B,S,K,hd), query head h reads kv head h / (H/K):
//
//   o[b,i,h] = sum_j softmax_j(mask(scale * q[b,i,h] . k[b,j,h/(H/K)])) v[b,j,h/(H/K)]
//
// with scale = hd^-0.5 applied to q in f32 after the load, scores, the
// running max m, the running sum l and the accumulator in f32, a masked
// score set to NEG_INF = -1e30 by a select (causal: j <= i; window: j > i -
// window), the correction exp(m_prev - m_new), kv tiles that are wholly
// masked skipped by the TPU kernel's tile predicate, a row with l == 0
// written as 0, and the output cast to q's dtype.  Because NEG_INF is
// finite, a masked entry of a live tile gives exp(-1e30 - m) = 0 once the
// row has a real score and 1 while m is still -1e30; the first real score
// scales those 1s away by exp(-1e30 - m_new) = 0, as on the TPU.  No NaN
// can arise: every value entering an exp is finite.
//
// Bound: operations.  Causal prefill at smollm-360m's heads (H=15, K=5,
// hd=64) does 4*hd*B*H*S(S+1)/2 multiply-adds counted as two operations
// each (8.06 GFLOP at B=4, S=1024) on 21 MB of q, k, v and o: far above the
// H100's ridge, so the least time is the product over the bf16 tensor-core
// rate.  This first kernel runs f32 FMAs on the CUDA cores out of shared
// memory (no tensor cores, no TMA, no warp specialisation): a right, simple
// kernel; wgmma and TMA are later work.
//
// Design.
//  - The TPU grid (B*H, n_q, n_kv) runs its kv axis in order on one core
//    with m, l, acc in VMEM scratch.  Here one block owns one (b, h) and a
//    tile of kQ = 64 query rows, and walks the kv tiles (kK = 64 rows) in
//    order in a loop, with m, l and acc in registers.  Blocks of one head
//    are adjacent in the grid, so its k and v tiles are shared through L2.
//  - q, k and v are read in place through their (B,S,H,hd) / (B,S,K,hd)
//    layout; there is no transpose copy.  K and V are never widened to H
//    heads: the block indexes kv head h / (H/K).
//  - The tiles are the kernel's own, not the TPU's 512-row blocks, and a
//    ragged last tile is masked: a q row past S is loaded as zeros and never
//    written, a k or v row past S is loaded as zeros and its score masked
//    before the row max.  So any S runs.
//  - 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns query rows
//    ty + 16r (r < 4): their m and l (kept alike by the 16 threads of a
//    half-warp), a 4 x 4 tile of scores (columns tx + 16c of the kv tile)
//    and the accumulator columns tx + 16c (c < hd / 16).  Row max and row
//    sum are shuffles across the half-warp.
//  - Shared memory holds q (scaled, f32), the k and v tiles (f32) and the
//    probabilities: rows padded by 4 floats, so each quarter-warp's 16-byte
//    loads of neighbouring rows fall on distinct banks.  At hd = 64 that is
//    69.6 KB, at hd = 128 118.8 KB, set with cudaFuncSetAttribute.
//
// The kernel allocates nothing and launches on the caller's stream; the
// launch error is returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;         // query rows of a tile
constexpr int kK = 64;         // kv rows of a tile
constexpr int kThreads = 256;
constexpr int kPS = kK + 4;    // row stride of the probability tile
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared-memory limit

// dtype codes shared with the Python wrapper (q, k, v and o alike)
enum : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int HD>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kQ + 2 * kK) * (HD + 4) + static_cast<size_t>(kQ) * kPS) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int H, int K,
                       int n_qt, int causal, int window, float scale) {
  constexpr int kDS = HD + 4;  // row stride of the q, k and v tiles
  constexpr int kNC = HD / 16;  // accumulator columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [kQ][kDS]  scale * q
  float* Ks = Qs + kQ * kDS;   // [kK][kDS]
  float* Vs = Ks + kK * kDS;   // [kK][kDS]
  float* Ps = Vs + kK * kDS;   // [kQ][kPS]  probabilities of the tile

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kQ;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const long long q_row = static_cast<long long>(H) * HD;   // elements between q rows
  const long long kv_row = static_cast<long long>(K) * HD;  // and between k / v rows
  const T* qb = q + (static_cast<long long>(b) * S) * q_row + static_cast<long long>(h) * HD;
  const T* kb = k + (static_cast<long long>(b) * S) * kv_row + static_cast<long long>(kh) * HD;
  const T* vb = v + (static_cast<long long>(b) * S) * kv_row + static_cast<long long>(kh) * HD;

  // q, scaled in f32 after the load (q_ref[0].astype(f32) * scale)
  for (int i = tid; i < kQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    Qs[r * kDS + d] = q0 + r < S ? to_f32(qb[(q0 + r) * q_row + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kNC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[r][c] = 0.f;
  }

  // the live kv tiles: the TPU kernel's predicate (flash_attention.py:48-53)
  // at this kernel's tile sizes.  Causal: kv tile start <= last q row.
  // Window: kv tile end > first q row - window.
  const int n_kt = (S + kK - 1) / kK;
  int kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (q0 + kQ - 1) / kK + 1);
  int kt_begin = 0;
  if (window > 0) {
    // smallest kt with kt * kK + kK - 1 > q0 - window
    const int lim = q0 - window - (kK - 1);  // need kt * kK > lim
    kt_begin = lim < 0 ? 0 : lim / kK + 1;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are no longer read
    for (int i = tid; i < kK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < S;
      Ks[r * kDS + d] = in ? to_f32(kb[(k0 + r) * kv_row + d]) : 0.f;
      Vs[r * kDS + d] = in ? to_f32(vb[(k0 + r) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16r, columns tx + 16c
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a4[4], b4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a4[r] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * r) * kDS + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b4[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * kDS + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float t = s[r][c];
          t = fmaf(a4[r].x, b4[c].x, t);
          t = fmaf(a4[r].y, b4[c].y, t);
          t = fmaf(a4[r].z, b4[c].z, t);
          t = fmaf(a4[r].w, b4[c].w, t);
          s[r][c] = t;
        }
    }

    // mask by select, then the online softmax of each row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty + 16 * r;
      float mc = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        bool ok = kp < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[r][c] = ok ? s[r][c] : kNegInf;
        mc = fmaxf(mc, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[r], mc);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        rs += p;
        Ps[(ty + 16 * r) * kPS + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = corr * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    // acc += p . v over the tile
#pragma unroll 2
    for (int j = 0; j < kK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p4[r] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * r) * kPS + j]);
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const float v0 = Vs[(j + 0) * kDS + tx + 16 * c];
        const float v1 = Vs[(j + 1) * kDS + tx + 16 * c];
        const float v2 = Vs[(j + 2) * kDS + tx + 16 * c];
        const float v3 = Vs[(j + 3) * kDS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float t = acc[r][c];
          t = fmaf(p4[r].x, v0, t);
          t = fmaf(p4[r].y, v1, t);
          t = fmaf(p4[r].z, v2, t);
          t = fmaf(p4[r].w, v3, t);
          acc[r][c] = t;
        }
      }
    }
  }

  // o = acc / l, a row with l == 0 written as 0 (acc is 0 there)
  T* ob = o + (static_cast<long long>(b) * S) * q_row + static_cast<long long>(h) * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty + 16 * r;
    if (qp >= S) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < kNC; ++c) store(&ob[qp * q_row + tx + 16 * c], acc[r][c] / den);
  }
}

template <typename T, int HD>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int H, int K, int causal, int window, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= kMaxSmem, "flash_attention tiles exceed an H100 block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (S + kQ - 1) / kQ;
  const long long blocks = static_cast<long long>(B) * H * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attention_kernel<T, HD><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, K, n_qt, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                      int K, int hd, int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_typed<T, 16>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    case 32: return launch_typed<T, 32>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    case 64: return launch_typed<T, 64>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    case 128: return launch_typed<T, 128>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k and v (B,S,K,hd), all contiguous and of dtype_code ->
// o (B,S,H,hd) of the same dtype.  hd in {16, 32, 64, 128}, H % K == 0;
// window <= 0 means no window.  Returns the cudaError_t of the launch (0 on
// success).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                           int H, int K, int hd, int causal, int window, float scale,
                           int dtype_code, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kF32)
    return launch_hd<float>(q, k, v, o, B, S, H, K, hd, causal, window, scale, s);
  if (dtype_code == kBF16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, K, hd, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
