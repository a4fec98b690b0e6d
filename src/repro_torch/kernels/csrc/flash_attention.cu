// flash_attention: online-softmax attention for sm_90a: prefill's forward,
// and training's forward and backward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:93
// flash_attention_pallas (pallas_call body _flash_kernel, :32-86).  For
// q (B,S,H,hd) and k, v (B,S,K,hd), query head h reads kv head h / (H/K):
//
//   o[b,i,h] = sum_j softmax_j(mask(scale * q[b,i,h] . k[b,j,h/(H/K)])) v[b,j,h/(H/K)]
//
// with scale = hd^-0.5, scores, the running max m, the running sum l and the
// accumulator in f32, a masked score set to NEG_INF = -1e30 by a select
// (causal: j <= i; window: j > i - window), the correction exp(m_prev -
// m_new), kv tiles that are wholly masked skipped by the TPU kernel's tile
// predicate, a row with l == 0 written as 0, and the output cast to q's
// dtype.  Because NEG_INF is finite, a masked entry of a live tile gives
// exp(-1e30 - m) = 0 once the row has a real score and 1 while m is still
// -1e30; the first real score scales those 1s away by exp(-1e30 - m_new) = 0,
// as on the TPU.  No NaN can arise: every value entering an exp is finite.
//
// Prefill: two instantiations, chosen by the dtype code of the C entry
// point and by nothing else (neither is a fallback of the other):
//
//  - bf16: the tensor-core kernel below (flash_bf16_kernel<HD, false>): wgmma
//    fed by TMA.  This is the serving prefill's path.
//  - f32: the CUDA-core kernel (flash_attention_kernel<float, HD>): f32
//    FMAs out of shared memory.  It serves the f32 cross-checks only.
//
// Training (bf16 only; no TPU kernel: the JAX trainer differentiates its
// plain attention): flash_bf16_kernel<HD, true> forward, and a backward of
// three launches.  Their precision contract is the model's own rounding
// (models/attention.py), not prefill's one bf16 spacing: q arrives scaled by
// hd^-0.5 in bf16 and the kernel folds only log2 e into the exponent, p is
// rounded once to bf16 for P.V, and the forward writes each row's log2-sum-
// exp2 (lse, f32) beside o.  The backward (flash_bwd_*):
//  - D = rowsum(dO o O) in f32, one thread a row;
//  - dQ, one block per (b, h, 128 q rows), walking the kv tiles of the
//    forward's predicate: S = Q.K^T and dP = dO.V^T (f32 accumulators),
//    P = 2^(S log2 e - lse), dS = P o (dP - D), dQ += dS.K;
//  - dK and dV, one block per (b, kv head, 128 kv rows), K and V held in
//    shared memory while the block walks the G query heads of the kv head
//    and their 64-row q tiles that the causal or window predicate keeps:
//    S^T = K.Q^T, dP^T = V.dO^T, dV += bf16(P^T).dO, dK += dS^T.Q.  GQA's
//    sum over the G heads stays in the block's registers.
//  No atomics: every output element has one owner and a fixed order of
//  sums, so two calls are bit-equal.  P enters P^T.dO as bf16, as the model
//  rounds it; dS enters dQ and dK split into bf16 hi + lo (two wgmmas into
//  one f32 accumulator), where the plain chain multiplies it in f32.  Both
//  passes are warp-specialised as the forward: a TMA producer warpgroup (lse
//  and D rows by cp.async.bulk) and two consumer warpgroups.  The backward
//  does S, dP, P.dO once and dS.Q and dS.K twice (hi + lo), and S and dP a
//  second time in the dQ pass: 4.5x the forward's least work.
//
// Bound: operations.  Causal prefill at smollm-360m's heads (H=15, K=5,
// hd=64) does 4*hd*B*H*S(S+1)/2 multiply-adds counted as two operations
// each (8.06 GFLOP at B=4, S=1024) on 21 MB of q, k, v and o: far above the
// H100's ridge, so the least time is the product over the bf16 tensor-core
// rate, and the tensor cores are the lever.  Training is the same: the
// backward's products on tiles of 64 and 128 rows, its elementwise work of
// five operations an S entry.
//
// The bf16 forward (prefill's arithmetic; training's differs as above).
//  - Arithmetic.  S = Q.K^T on bf16 q and k as they are, f32 accumulators
//    (the products are exact, so S differs from the plain version's only in
//    summation order); the f32 score is then multiplied by hd^-0.5 * log2(e)
//    (folded into the fma before the exponent off the masked tiles) and
//    exponentiated by ex2.approx (f32 rounding only).  P.V is split: P_hi =
//    bf16(p), P_lo = bf16(p - P_hi), two wgmmas into one f32 accumulator.
//    p rounded once to bf16 breaks the one-bf16-spacing hold of the output;
//    the split keeps p to ~2^-16 (tests/test_torch_flash.py emulates both).
//    So P.V is twice the least work, and the whole kernel 1.5x.
//  - Layout.  One block owns one (b, h) and kBQ = 128 query rows: two
//    consumer warpgroups of 64 rows each, and a producer warpgroup that
//    hands its registers to them (setmaxnreg: 40 and 232 a thread).  kv
//    tiles are kBK = 128 rows at hd <= 64 and 64 at hd 128 (the registers of
//    S, P_hi, P_lo and O).  The grid runs the query tiles longest first (the
//    last tile of a causal head has the most kv tiles), the heads of one kv
//    head adjacent so their K and V tiles are shared through L2.
//  - Loads.  TMA over 4-D tensor maps of the JAX layout, (hd, H, S, B) for
//    q and (hd, K, S, B) for k and v (byte strides hd*2, heads*hd*2,
//    S*heads*hd*2): no transpose copy, kv head h / (H/K) by coordinate.  Q
//    is loaded once per block; K and V tiles run through a ring of kStages
//    stages, each tracked by a full and an empty mbarrier: the producer's
//    lane 0 issues the next tiles while the consumers compute on the
//    current one.  Rows past S are filled with zeros by TMA and their scores
//    masked before the row max, so any S runs.
//  - Swizzle.  A tile row of min(hd, 64) bf16 is 32, 64 or 128 bytes, and
//    the tensor map swizzles by that width (hd 16: 32 B, 32: 64 B, 64 and
//    128: 128 B; hd 128 as two 64-column boxes).  The wgmma descriptors use
//    the same swizzle: Q and K K-major (hd contiguous), V MN-major (hd
//    contiguous, kv rows along the product's depth).
//  - Registers.  S lives in the accumulator registers of an m64nNk16 wgmma;
//    its fragment layout is the A-operand layout of the next wgmma, so P_hi
//    and P_lo feed P.V from registers and never touch shared memory.  Row
//    max and sum are quad shuffles; each thread owns two rows.
//  - Overlap.  Each warpgroup runs a software pipeline: S of tile j on the
//    tensor cores beside P.V of tile j - 1, its softmax beside the rest of
//    that P.V.  The two warpgroups take turns to issue (named barriers), so
//    one's softmax runs beside the other's products.
//  - Masking by tile.  The block walks the kv tiles that the TPU's tile
//    predicate keeps at (kBQ, kBK) tiles, and selects to NEG_INF only on
//    tiles that cross the diagonal, the window's edge or S.
//  - Output.  acc / l from registers to global memory as bf16 pairs, rows
//    past S never written.
//
// The f32 kernel.  One block owns one (b, h) and kQ = 64 query rows and
// walks the kv tiles (kK = 64 rows) in a loop with m, l and acc in
// registers; 256 threads, thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16r (r < 4) and accumulator columns tx + 16c; row max and row sum
// are half-warp shuffles.  Shared memory holds q (scaled by hd^-0.5 in f32
// after the load), the k and v tiles and the probabilities, rows padded by
// 4 floats; a q, k or v row past S is loaded as zeros.
//
// Neither kernel allocates; both launch on the caller's stream, and the
// launch error (or a failed tensor-map encode) is returned to the caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared-memory limit

// dtype codes shared with the Python wrapper (q, k, v and o alike)
enum : int { kF32 = 0, kBF16 = 1 };

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel

constexpr int kQ = 64;         // query rows of a tile
constexpr int kK = 64;         // kv rows of a tile
constexpr int kThreads = 256;
constexpr int kPS = kK + 4;    // row stride of the probability tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

constexpr int kBQ = 128;        // query rows of a block: two consumer warpgroups of 64
constexpr int kStages = 4;      // K/V ring depth
constexpr int kConsumers = 256;  // the two consumer warpgroups' threads
constexpr int kBThreads = kConsumers + 128;  // + the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 2^x on the MUFU unit, subnormal results flushed to 0 (below 2^-126 of a
// row's largest p, far under the output's bf16 spacing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barriers 1 and 2: the consumer warpgroups' turns at the tensor cores
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int HD>
struct Tiles {
  static constexpr int kCW = HD < 64 ? HD : 64;      // columns of a box (one swizzle row)
  static constexpr int kSW = kCW * 2;                // its bytes: the swizzle width
  static constexpr int kNC = HD / kCW;               // boxes across hd (2 at hd 128)
  static constexpr int kBK = HD <= 64 ? 128 : 64;    // kv rows of a tile
  static constexpr uint32_t kQBytes = kBQ * HD * 2;
  static constexpr uint32_t kKVBytes = kBK * HD * 2;  // one K or V tile
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * static_cast<size_t>(kKVBytes) + 64;
};

// grid: n_qt * B * H blocks, the query tiles longest first; block: two
// consumer warpgroups (rows 0-63, 64-127 of the tile) and a producer
// warpgroup.
// kTrain: the training instantiation (q scaled by the caller, scale 1; P
// rounded once to bf16 for P.V; the row's log2-sum-exp2 written to lse
// (B*H, S_pad) f32 for every row below S_pad).  Otherwise prefill's.
template <int HD, bool kTrain>
__global__ void __launch_bounds__(kBThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int S, int S_pad, int H, int K, int BH, int n_qt,
                  int causal, int window, float scale) {
  using T = Tiles<HD>;
  constexpr int kCW = T::kCW, kSW = T::kSW, kNC = T::kNC, kBK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  // TMA swizzle and wgmma descriptors want 1024-byte aligned tiles
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Qs = base;                    // [kNC][kBQ][kCW]
  uint8_t* Ks = Qs + T::kQBytes;         // [kStages][kNC][kBK][kCW]
  uint8_t* Vs = Ks + kStages * T::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * T::kKVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // longest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;

  // the block's kv tiles: the TPU's tile predicate (flash_attention.py:48-53)
  // at (kBQ, kBK) tiles
  const int n_kt = (S + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, (q0 + kBQ - 1) / kBK + 1) : n_kt;
  int kt_begin = 0;
  if (window > 0) {
    const int lim = q0 - window - (kBK - 1);  // need kt * kBK > lim
    kt_begin = lim < 0 ? 0 : lim / kBK + 1;
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: hands its registers to the consumers; lane 0 issues every
    // load.  The ring's empty barriers start in phase 0, so waiting on
    // parity 1 passes on the first round.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, T::kQBytes);
      for (int c = 0; c < kNC; ++c)
        tma_load(Qs + c * (kBQ * kSW), &tq, qbar, c * kCW, h, q0, b);
      int stage = 0, phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * T::kKVBytes);
        for (int c = 0; c < kNC; ++c) {
          tma_load(Ks + stage * T::kKVBytes + c * (kBK * kSW), &tk, &full[stage], c * kCW, kh,
                   kt * kBK, b);
          tma_load(Vs + stage * T::kKVBytes + c * (kBK * kSW), &tv, &full[stage], c * kCW, kh,
                   kt * kBK, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; thread (warp w,
  // lane) owns rows rA = 16 w + lane / 4 and rB = rA + 8 of them, and in
  // each 8-column block of S and O the columns 2 (lane % 4) + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int qw0 = q0 + 64 * wg;
  const int rowA = qw0 + 16 * warp + lane / 4, rowB = rowA + 8;
  const int col_in = 2 * (lane % 4);
  const float sl2 = scale * kLog2e;

  // tile kt sits in stage (kt - kt_begin) % kStages, in that stage's round
  // (kt - kt_begin) / kStages
  auto wait_full = [&](int kt) {
    const int i = kt - kt_begin;
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  };
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(kt - kt_begin) % kStages]);
  };
  auto stage_of = [&](int kt) { return (kt - kt_begin) % kStages; };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNC][kCW / 2];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kCW / 2; ++i) acc[c][i] = 0.f;
  float s[kBK / 2];
  uint32_t phi[kBK / 16][4], plo[kBK / 16][4];  // P of the previous tile, split

  // S = Q . K^T of tile kt, issued (not waited for)
  const uint8_t* Qw = Qs + 64 * wg * kSW;  // this warpgroup's 64 rows in each box
  auto issue_qk = [&](int kt) {
    const uint8_t* Kt = Ks + stage_of(kt) * T::kKVBytes;
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      // depth step t: box t * 16 / kCW, byte offset (t * 16 % kCW) * 2 in its row
      const int c = t * 16 / kCW, off = (t * 16 % kCW) * 2;
      wgmma_ss(s, smem_desc(Qw + c * (kBQ * kSW) + off, kSW, 16),
               smem_desc(Kt + c * (kBK * kSW) + off, kSW, 16), t);
    }
    wgmma_commit();
  };
  // O += P_hi . V + P_lo . V of tile kt, V MN-major: depth step kk is kv
  // rows 16 kk .. 16 kk + 15; issued (not waited for)
  auto issue_pv = [&](int kt) {
    const uint8_t* Vt = Vs + stage_of(kt) * T::kKVBytes;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = smem_desc(Vt + c * (kBK * kSW) + kk * 16 * kSW, kSW, kBK * kSW);
        wgmma_rs(acc[c], phi[kk], dv);
        if constexpr (!kTrain) wgmma_rs(acc[c], plo[kk], dv);
      }
    wgmma_commit();
  };
  // S of tile kt (landed) -> p = 2^(scaled s - m_new) in place; m and l
  // updated; corr returns the rescaling of the old O
  auto softmax = [&](int kt, float (&corr)[2]) {
    fence_regs(s);
    const int k0 = kt * kBK;
    // scale and mask by select on tiles that cross the diagonal, the
    // window's edge or S.  Register i holds column base + off(i) of its
    // row, live for lo < off <= hi: col < S, col <= row if causal, col >
    // row - window if windowed.
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > qw0) ||
                      (window > 0 && k0 <= qw0 + 63 - window);
    if (edge) {
      const int base = k0 + col_in;
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rowB : rowA;
        hi[r] = (causal ? min(S - 1, row) : S - 1) - base;
        lo[r] = window > 0 ? row - window - base : -1;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int off = 8 * (i / 4) + (i & 1), r = (i >> 1) & 1;
        s[i] = off > lo[r] && off <= hi[r] ? s[i] * sl2 : kNegInf;
      }
    }
    // the tile's row max; off the edge taken on the unscaled scores and
    // scaled after (sl2 > 0 and rounding are monotonic: the same max)
    float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], edge ? mx[r] : mx[r] * sl2);
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    // p = 2^(scaled s - m): off the edge the scale folds into one fma
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = ex2(fmaf(s[i], sl2, -m[(i >> 1) & 1]));
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) rs[(i >> 1) & 1] += s[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  };
  // p split into bf16 hi + bf16 lo of the remainder (training: hi alone),
  // packed in the A-operand layout of m64nNk16: register j of depth step kk
  // holds S registers 8 kk + 2 j, 8 kk + 2 j + 1
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const uint32_t hi = pack_bf16(s[i], s[i + 1]);
        phi[kk][j] = hi;
        if constexpr (!kTrain)
          plo[kk][j] = pack_bf16(s[i] - __uint_as_float(hi << 16),
                                 s[i + 1] - __uint_as_float(hi & 0xFFFF0000u));
      }
  };

  // the warpgroups take turns to issue their wgmmas (named barriers 1 and
  // 2), so one's softmax runs beside the other's products.  Warpgroup 0
  // goes first; each takes kt_end - kt_begin + 1 turns, and warpgroup 1
  // hands over none after its last.
  auto my_turn = [&]() { bar_sync(1 + wg, kConsumers); };
  auto your_turn = [&](bool last) {
    if (!(last && wg == 1)) bar_arrive(2 - wg, kConsumers);
  };
  if (wg == 1) bar_arrive(1, kConsumers);

  // software pipeline: S of tile kt runs on the tensor cores beside P.V of
  // tile kt - 1, and the softmax of kt beside the rest of that P.V.  Both
  // warpgroups walk the block's tiles (never empty: the diagonal or the
  // window's last tile is live); a tile wholly masked for one of them adds
  // 2^(-1e30 - m) = 0 once its rows have a real score, as on the TPU.
  mbar_wait(qbar, 0);
  float corr[2];
  wait_full(kt_begin);
  my_turn();
  wgmma_fence();
  issue_qk(kt_begin);
  your_turn(false);
  wgmma_wait<0>();
  softmax(kt_begin, corr);  // O is 0: nothing to rescale
  pack_p();
  for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
    wait_full(kt);
    my_turn();
    wgmma_fence();
    issue_qk(kt);
    issue_pv(kt - 1);
    your_turn(false);
    wgmma_wait<1>();  // S of kt has landed; P.V of kt - 1 may run on
    softmax(kt, corr);
    wgmma_wait<0>();
    release(kt - 1);
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      fence_regs(acc[c]);
#pragma unroll
      for (int i = 0; i < kCW / 2; ++i) acc[c][i] *= corr[(i >> 1) & 1];
    }
    pack_p();
  }
  my_turn();
  wgmma_fence();
  issue_pv(kt_end - 1);
  your_turn(true);
  wgmma_wait<0>();
  release(kt_end - 1);
#pragma unroll
  for (int c = 0; c < kNC; ++c) fence_regs(acc[c]);

  // o = acc / l, l summed over the quad; a row with l == 0 written as 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kTrain) {
    // log2 of the row's sum of 2^(s log2 e): m + log2 l, finite on every row
    // (a row past S scores 0s or, windowed past S, all -1e30s)
    if ((lane & 3) == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rowB : rowA;
        if (row < S_pad) lse[static_cast<long long>(bh) * S_pad + row] = m[r] + log2f(l[r]);
      }
  }
  const long long row_stride = static_cast<long long>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rowB : rowA;
    if (row >= S) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = o + (static_cast<long long>(b) * S + row) * row_stride +
                          static_cast<long long>(h) * HD;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int j = 0; j < kCW / 8; ++j) {
        const float x0 = acc[c][4 * j + 2 * r], x1 = acc[c][4 * j + 2 * r + 1];
        *reinterpret_cast<__nv_bfloat162*>(orow + c * kCW + 8 * j + col_in) =
            __floats2bfloat162_rn(x0 / den, x1 / den);
      }
  }
}


// ---------------------------------------------------------------------------
// bf16 training backward: three launches (D, dQ, dK and dV), no atomics

// cp.async.bulk of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// D = rowsum(dO o O) in f32, (B*H, S_pad), 0 past S: one thread a row
constexpr int kDotThreads = 256;

__global__ void __launch_bounds__(kDotThreads)
flash_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                     float* __restrict__ dsum, int S, int S_pad, int H, int hd, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kDotThreads + threadIdx.x;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % S_pad);
  const long long bh = idx / S_pad;
  float acc = 0.f;
  if (i < S) {
    const long long off = ((bh / H * S + i) * H + bh % H) * hd;
    const uint4* po = reinterpret_cast<const uint4*>(o + off);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
    for (int c = 0; c < hd / 8; ++c) {
      const uint4 a = po[c], d = pd[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(a2[j]), fd = __bfloat1622float2(d2[j]);
        acc = fmaf(fa.x, fd.x, acc);
        acc = fmaf(fa.y, fd.y, acc);
      }
    }
  }
  dsum[idx] = acc;
}

constexpr int kBKd = 64;    // dQ pass: kv rows of a tile (its q tile is kBQ = 128)
constexpr int kBKV = 128;   // dK/dV pass: kv rows of a block, two warpgroups of 64
constexpr int kBQd = 64;    // dK/dV pass: q rows of a tile

template <int HD>
struct BwdTiles {
  static constexpr uint32_t kQ128 = kBQ * HD * 2;   // a 128-row q / dO / k / v tile
  static constexpr uint32_t kT64 = kBQd * HD * 2;   // a 64-row one
  // dQ: Q and dO of the block, a ring of 64-row K and V tiles
  static constexpr size_t kSmemDQ =
      1024 + 2 * kQ128 + 2 * kStages * static_cast<size_t>(kT64) + 128;
  // dK/dV: K and V of the block, a ring of 64-row Q and dO tiles with their
  // 64 rows of lse and D
  static constexpr size_t kSmemDKV =
      1024 + 2 * kQ128 + kStages * (2 * static_cast<size_t>(kT64) + 2 * kBQd * 4) + 128;
};

// dQ = dS . K of the scaled q, one block per (b, h, 128-row q tile), the
// query tiles longest first; the kv tiles of the forward's predicate at
// (kBQ, kBKd).  Per kv tile each consumer warpgroup (64 q rows) computes S =
// Q.K^T and dP = dO.V^T (f32 accumulators), P = 2^(S log2 e - lse), dS = P
// o (dP - D), and dQ += dS_hi.K + dS_lo.K with dS split into bf16 hi + lo.
template <int HD>
__global__ void __launch_bounds__(kBThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int S, int S_pad, int H, int K, int BH,
                    int n_qt, int causal, int window) {
  using T = Tiles<HD>;
  using BT = BwdTiles<HD>;
  constexpr int kCW = T::kCW, kSW = T::kSW, kNC = T::kNC, kBK = kBKd;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Qs = base;                 // [kNC][kBQ][kCW]
  uint8_t* dOs = Qs + BT::kQ128;      // [kNC][kBQ][kCW]
  uint8_t* Ks = dOs + BT::kQ128;      // [kStages][kNC][kBK][kCW]
  uint8_t* Vs = Ks + kStages * BT::kT64;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * BT::kT64);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // longest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int n_kt = (S + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, (q0 + kBQ - 1) / kBK + 1) : n_kt;
  int kt_begin = 0;
  if (window > 0) {
    const int lim = q0 - window - (kBK - 1);
    kt_begin = lim < 0 ? 0 : lim / kBK + 1;
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, 2 * BT::kQ128);
      for (int c = 0; c < kNC; ++c) {
        tma_load(Qs + c * (kBQ * kSW), &tq, qbar, c * kCW, h, q0, b);
        tma_load(dOs + c * (kBQ * kSW), &tdo, qbar, c * kCW, h, q0, b);
      }
      int stage = 0, phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * BT::kT64);
        for (int c = 0; c < kNC; ++c) {
          tma_load(Ks + stage * BT::kT64 + c * (kBK * kSW), &tk, &full[stage], c * kCW, kh,
                   kt * kBK, b);
          tma_load(Vs + stage * BT::kT64 + c * (kBK * kSW), &tv, &full[stage], c * kCW, kh,
                   kt * kBK, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int qw0 = q0 + 64 * wg;
  const int rowA = qw0 + 16 * warp + lane / 4, rowB = rowA + 8;
  const int col_in = 2 * (lane % 4);
  // each row's lse (log2 units) and D; a row past S reads 0s
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rowB : rowA;
    const long long at = static_cast<long long>(bh) * S_pad + row;
    lr[r] = row < S ? lse[at] : 0.f;
    dr[r] = row < S ? dsum[at] : 0.f;
  }

  float acc[kNC][kCW / 2];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kCW / 2; ++i) acc[c][i] = 0.f;
  float s[kBK / 2], dp[kBK / 2];
  uint32_t dhi[kBK / 16][4], dlo[kBK / 16][4];
  const uint8_t* Qw = Qs + 64 * wg * kSW;
  const uint8_t* dOw = dOs + 64 * wg * kSW;

  mbar_wait(qbar, 0);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin, stage = it % kStages;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const uint8_t* Kt = Ks + stage * BT::kT64;
    const uint8_t* Vt = Vs + stage * BT::kT64;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const int c = t * 16 / kCW, off = (t * 16 % kCW) * 2;
      wgmma_ss(s, smem_desc(Qw + c * (kBQ * kSW) + off, kSW, 16),
               smem_desc(Kt + c * (kBK * kSW) + off, kSW, 16), t);
    }
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const int c = t * 16 / kCW, off = (t * 16 % kCW) * 2;
      wgmma_ss(dp, smem_desc(dOw + c * (kBQ * kSW) + off, kSW, 16),
               smem_desc(Vt + c * (kBK * kSW) + off, kSW, 16), t);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // P = 2^(S log2 e - lse), 0 where masked (a select, on the tiles that
    // cross the diagonal, the window's edge or S)
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > qw0) ||
                      (window > 0 && k0 <= qw0 + 63 - window);
    if (edge) {
      const int base = k0 + col_in;
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rowB : rowA;
        hi[r] = (causal ? min(S - 1, row) : S - 1) - base;
        lo[r] = window > 0 ? row - window - base : -1;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int off = 8 * (i / 4) + (i & 1), r = (i >> 1) & 1;
        const float p = ex2(fmaf(s[i], kLog2e, -lr[r]));
        s[i] = off > lo[r] && off <= hi[r] ? p : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = ex2(fmaf(s[i], kLog2e, -lr[(i >> 1) & 1]));
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P o (dP - D), split into bf16 hi + lo in the A-operand layout
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const float d = dr[(i >> 1) & 1];
        const float d0 = s[i] * (dp[i] - d), d1 = s[i + 1] * (dp[i + 1] - d);
        const uint32_t hi = pack_bf16(d0, d1);
        dhi[kk][j] = hi;
        dlo[kk][j] = pack_bf16(d0 - __uint_as_float(hi << 16),
                               d1 - __uint_as_float(hi & 0xFFFF0000u));
      }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dk = smem_desc(Kt + c * (kBK * kSW) + kk * 16 * kSW, kSW, kBK * kSW);
        wgmma_rs(acc[c], dhi[kk], dk);
        wgmma_rs(acc[c], dlo[kk], dk);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kNC; ++c) fence_regs(acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  const long long row_stride = static_cast<long long>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rowB : rowA;
    if (row >= S) continue;
    __nv_bfloat16* drow = dq + (static_cast<long long>(b) * S + row) * row_stride +
                          static_cast<long long>(h) * HD;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int j = 0; j < kCW / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(drow + c * kCW + 8 * j + col_in) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r], acc[c][4 * j + 2 * r + 1]);
  }
}

// dK and dV, one block per (b, kv head, 128-row kv tile), the kv tiles with
// the most query tiles first; each consumer warpgroup owns 64 kv rows and
// keeps dK and dV in registers while the block walks the G query heads of
// its kv head and, in each, the 64-row query tiles that the causal or
// window predicate keeps.  Per tile: S^T = K.Q^T, dP^T = V.dO^T, P^T =
// 2^(S^T log2 e - lse), dS^T = P^T o (dP^T - D), dV += bf16(P^T).dO, dK +=
// dS^T_hi.Q + dS^T_lo.Q.  The sum over the G heads stays in the block.
template <int HD>
__global__ void __launch_bounds__(kBThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int S_pad, int H, int K, int BK,
                      int causal, int window) {
  using T = Tiles<HD>;
  using BT = BwdTiles<HD>;
  constexpr int kCW = T::kCW, kSW = T::kSW, kNC = T::kNC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Ks = base;                          // [kNC][kBKV][kCW]
  uint8_t* Vs = Ks + BT::kQ128;                // [kNC][kBKV][kCW]
  uint8_t* Qs = Vs + BT::kQ128;                // [kStages][kNC][kBQd][kCW]
  uint8_t* dOs = Qs + kStages * BT::kT64;      // [kStages][kNC][kBQd][kCW]
  float* Ls = reinterpret_cast<float*>(dOs + kStages * BT::kT64);  // [kStages][kBQd]
  float* Ds = Ls + kStages * kBQd;                                  // [kStages][kBQd]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + kStages * kBQd);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int kt = static_cast<int>(blockIdx.x) / BK;  // kv tile 0 has the most q tiles
  const int bk = static_cast<int>(blockIdx.x) % BK;
  const int b = bk / K, kh = bk % K;
  const int G = H / K;
  const int k0 = kt * kBKV;
  const int n_qt = (S + kBQd - 1) / kBQd;
  // live q tiles: causal, last row >= k0; windowed, first row < last kv
  // row + window
  const int qt_begin = causal ? k0 / kBQd : 0;
  const int qt_end = window > 0 ? min(n_qt, (k0 + kBKV - 2 + window) / kBQd + 1) : n_qt;
  const int n_q = qt_end - qt_begin;
  const int n_it = G * n_q;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      mbar_expect_tx(kvbar, 2 * BT::kQ128);
      for (int c = 0; c < kNC; ++c) {
        tma_load(Ks + c * (kBKV * kSW), &tk, kvbar, c * kCW, kh, k0, b);
        tma_load(Vs + c * (kBKV * kSW), &tv, kvbar, c * kCW, kh, k0, b);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_it; ++it) {
        const int h = kh * G + it / n_q, q0 = (qt_begin + it % n_q) * kBQd;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * BT::kT64 + 2 * kBQd * 4);
        for (int c = 0; c < kNC; ++c) {
          tma_load(Qs + stage * BT::kT64 + c * (kBQd * kSW), &tq, &full[stage], c * kCW, h, q0, b);
          tma_load(dOs + stage * BT::kT64 + c * (kBQd * kSW), &tdo, &full[stage], c * kCW, h, q0,
                   b);
        }
        const long long at = (static_cast<long long>(b) * H + h) * S_pad + q0;
        bulk_load(Ls + stage * kBQd, lse + at, kBQd * 4, &full[stage]);
        bulk_load(Ds + stage * kBQd, dsum + at, kBQd * 4, &full[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int kw0 = k0 + 64 * wg;
  const int rowA = kw0 + 16 * warp + lane / 4, rowB = rowA + 8;
  const int col_in = 2 * (lane % 4);

  float dK[kNC][kCW / 2], dV[kNC][kCW / 2];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < kCW / 2; ++i) dK[c][i] = dV[c][i] = 0.f;
  float st[kBQd / 2], dpt[kBQd / 2];
  uint32_t pp[kBQd / 16][4], dhi[kBQd / 16][4], dlo[kBQd / 16][4];
  const uint8_t* Kw = Ks + 64 * wg * kSW;
  const uint8_t* Vw = Vs + 64 * wg * kSW;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it % kStages;
    const int q0 = (qt_begin + it % n_q) * kBQd;
    mbar_wait(&full[stage], (it / kStages) & 1);
    const uint8_t* Qt = Qs + stage * BT::kT64;
    const uint8_t* dOt = dOs + stage * BT::kT64;
    const float* L = Ls + stage * kBQd;
    const float* Dd = Ds + stage * kBQd;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const int c = t * 16 / kCW, off = (t * 16 % kCW) * 2;
      wgmma_ss(st, smem_desc(Kw + c * (kBKV * kSW) + off, kSW, 16),
               smem_desc(Qt + c * (kBQd * kSW) + off, kSW, 16), t);
    }
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const int c = t * 16 / kCW, off = (t * 16 % kCW) * 2;
      wgmma_ss(dpt, smem_desc(Vw + c * (kBKV * kSW) + off, kSW, 16),
               smem_desc(dOt + c * (kBQd * kSW) + off, kSW, 16), t);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);
    // register i holds kv row (i >> 1) & 1 of the thread's two and q column
    // q0 + 8 (i / 4) + (i & 1) + col_in; P^T is 0 where masked, by a select
    // on the tiles that cross the diagonal, the window's edge or S
    const bool edge = q0 + kBQd > S || (causal && q0 < kw0 + 63) ||
                      (window > 0 && q0 + kBQd - 1 - window >= kw0);
#pragma unroll
    for (int i = 0; i < kBQd / 2; ++i) {
      const int lc = 8 * (i / 4) + (i & 1) + col_in;
      const float p = ex2(fmaf(st[i], kLog2e, -L[lc]));
      if (edge) {
        const int row = (i >> 1) & 1 ? rowB : rowA, qi = q0 + lc;
        const bool ok = qi < S && (!causal || row <= qi) && (window <= 0 || row > qi - window);
        st[i] = ok ? p : 0.f;
      } else {
        st[i] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < kBQd / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const int lc = 8 * (i / 4) + col_in;  // columns lc, lc + 1
        pp[kk][j] = pack_bf16(st[i], st[i + 1]);
        const float d0 = st[i] * (dpt[i] - Dd[lc]), d1 = st[i + 1] * (dpt[i + 1] - Dd[lc + 1]);
        const uint32_t hi = pack_bf16(d0, d1);
        dhi[kk][j] = hi;
        dlo[kk][j] = pack_bf16(d0 - __uint_as_float(hi << 16),
                               d1 - __uint_as_float(hi & 0xFFFF0000u));
      }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int kk = 0; kk < kBQd / 16; ++kk) {
        const uint32_t o = c * (kBQd * kSW) + kk * 16 * kSW;
        wgmma_rs(dV[c], pp[kk], smem_desc(dOt + o, kSW, kBQd * kSW));
        const uint64_t dq = smem_desc(Qt + o, kSW, kBQd * kSW);
        wgmma_rs(dK[c], dhi[kk], dq);
        wgmma_rs(dK[c], dlo[kk], dq);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      fence_regs(dK[c]);
      fence_regs(dV[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  const long long row_stride = static_cast<long long>(K) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rowB : rowA;
    if (row >= S) continue;
    const long long at = (static_cast<long long>(b) * S + row) * row_stride +
                         static_cast<long long>(kh) * HD;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int j = 0; j < kCW / 8; ++j) {
        const int col = c * kCW + 8 * j + col_in;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
            __floats2bfloat162_rn(dK[c][4 * j + 2 * r], dK[c][4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(dV[c][4 * j + 2 * r], dV[c][4 * j + 2 * r + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// host side

// cuTensorMapEncodeTiled from the driver the process has loaded (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* drv = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return drv ? reinterpret_cast<EncodeTiled>(dlsym(drv, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// the 4-D map (hd, heads, S, B) of a contiguous (B, S, heads, hd) bf16
// tensor, boxes of min(hd, 64) columns x `rows` rows, swizzled by a box row,
// zeros past S
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int hd, int heads, int S,
                int B, int rows) {
  const cuuint32_t cw = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2,
                                 static_cast<cuuint64_t>(S) * heads * hd * 2};
  const cuuint32_t box[4] = {cw, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kTrain>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int S_pad, int H, int K, int causal, int window, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = Tiles<HD>::kSmem;
  static_assert(smem <= kMaxSmem, "flash_attention tiles exceed an H100 block's shared memory");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, HD, H, S, B, kBQ) ||
      !tensor_map(encode, &tk, k, HD, K, S, B, Tiles<HD>::kBK) ||
      !tensor_map(encode, &tv, v, HD, K, S, B, Tiles<HD>::kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<HD, kTrain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(B) * H * n_qt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bf16_kernel<HD, kTrain><<<static_cast<unsigned>(blocks), kBThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, S_pad, H, K, B * H, n_qt, causal,
      window, scale);
  return cudaGetLastError();
}

template <bool kTrain>
cudaError_t launch_bf16_hd(const void* q, const void* k, const void* v, void* o, float* lse,
                           int B, int S, int S_pad, int H, int K, int hd, int causal, int window,
                           float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_bf16<16, kTrain>(q, k, v, o, lse, B, S, S_pad, H, K, causal, window, scale,
                                     stream);
    case 32:
      return launch_bf16<32, kTrain>(q, k, v, o, lse, B, S, S_pad, H, K, causal, window, scale,
                                     stream);
    case 64:
      return launch_bf16<64, kTrain>(q, k, v, o, lse, B, S, S_pad, H, K, causal, window, scale,
                                     stream);
    case 128:
      return launch_bf16<128, kTrain>(q, k, v, o, lse, B, S, S_pad, H, K, causal, window, scale,
                                      stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                       void* dv, int B, int S, int S_pad, int H, int K, int causal, int window,
                       cudaStream_t stream) {
  using BT = BwdTiles<HD>;
  static_assert(BT::kSmemDQ <= kMaxSmem && BT::kSmemDKV <= kMaxSmem,
                "flash_attention backward tiles exceed an H100 block's shared memory");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  // dQ reads 128-row q and dO tiles and 64-row k and v tiles; dK/dV the
  // other way round
  CUtensorMap tq128, tdo128, tk64, tv64, tq64, tdo64, tk128, tv128;
  if (!tensor_map(encode, &tq128, q, HD, H, S, B, kBQ) ||
      !tensor_map(encode, &tdo128, dout, HD, H, S, B, kBQ) ||
      !tensor_map(encode, &tk64, k, HD, K, S, B, kBKd) ||
      !tensor_map(encode, &tv64, v, HD, K, S, B, kBKd) ||
      !tensor_map(encode, &tq64, q, HD, H, S, B, kBQd) ||
      !tensor_map(encode, &tdo64, dout, HD, H, S, B, kBQd) ||
      !tensor_map(encode, &tk128, k, HD, K, S, B, kBKV) ||
      !tensor_map(encode, &tv128, v, HD, K, S, B, kBKV))
    return cudaErrorInvalidValue;
  const int n_qt = (S + kBQ - 1) / kBQ, n_kvt = (S + kBKV - 1) / kBKV;
  const long long dq_blocks = static_cast<long long>(B) * H * n_qt;
  const long long kv_blocks = static_cast<long long>(B) * K * n_kvt;
  const long long total = static_cast<long long>(B) * H * S_pad;
  const long long dot_blocks = (total + kDotThreads - 1) / kDotThreads;
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL || dot_blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(BT::kSmemDQ));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(BT::kSmemDKV));
  if (err != cudaSuccess) return err;
  flash_bwd_dot_kernel<<<static_cast<unsigned>(dot_blocks), kDotThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), dsum, S,
      S_pad, H, HD, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<HD><<<static_cast<unsigned>(dq_blocks), kBThreads, BT::kSmemDQ, stream>>>(
      tq128, tk64, tv64, tdo128, lse, dsum, static_cast<__nv_bfloat16*>(dq), S, S_pad, H, K,
      B * H, n_qt, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<HD>
      <<<static_cast<unsigned>(kv_blocks), kBThreads, BT::kSmemDKV, stream>>>(
          tq64, tk128, tv128, tdo64, lse, dsum, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), S, S_pad, H, K, B * K, causal, window);
  return cudaGetLastError();
}

bool train_shape_ok(int B, int S, int S_pad, int H, int K) {
  return B >= 1 && S >= 1 && H >= 1 && K >= 1 && H % K == 0 && S_pad % kBQ == 0 && S_pad >= S &&
         S_pad < S + kBQ;
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k and v (B,S,K,hd), all contiguous and of dtype_code ->
// o (B,S,H,hd) of the same dtype.  hd in {16, 32, 64, 128}, H % K == 0;
// window <= 0 means no window.  bf16 runs the tensor-core kernel (q, k and v
// 16-byte aligned, as TMA asks), f32 the CUDA-core kernel.  Returns the
// cudaError_t of the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                           int H, int K, int hd, int causal, int window, float scale,
                           int dtype_code, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == kF32)
    return launch_hd<float>(q, k, v, o, B, S, H, K, hd, causal, window, scale, s);
  if (dtype_code == kBF16)
    return launch_bf16_hd<false>(q, k, v, o, nullptr, B, S, 0, H, K, hd, causal, window, scale,
                                 s);
  return cudaErrorInvalidValue;
}

// Training forward, bf16 only: q (B,S,H,hd) already scaled by hd^-0.5, k
// and v (B,S,K,hd), all contiguous and 16-byte aligned -> o (B,S,H,hd) and
// lse (B*H, S_pad) f32, the log2 of each row's sum of 2^(s log2 e), written
// for every row below S_pad (S_pad: S rounded up to 128).
int flash_attention_train_forward(const void* q, const void* k, const void* v, void* o,
                                  float* lse, int B, int S, int S_pad, int H, int K, int hd,
                                  int causal, int window, void* stream) {
  if (!train_shape_ok(B, S, S_pad, H, K)) return cudaErrorInvalidValue;
  return launch_bf16_hd<true>(q, k, v, o, lse, B, S, S_pad, H, K, hd, causal, window, 1.f,
                              static_cast<cudaStream_t>(stream));
}

// Training backward, bf16 only, the forward's inputs and outputs with dout
// (B,S,H,hd) -> dq (of the scaled q), dk, dv in their inputs' shapes, bf16;
// dsum (B*H, S_pad) f32 is scratch (D = rowsum(dO o O)).  Three launches:
// D, then dQ, then dK and dV.
int flash_attention_train_backward(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* dsum, void* dq,
                                   void* dk, void* dv, int B, int S, int S_pad, int H, int K,
                                   int hd, int causal, int window, void* stream) {
  if (!train_shape_ok(B, S, S_pad, H, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_bwd<16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, S_pad, H, K, causal,
                            window, s);
    case 32:
      return launch_bwd<32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, S_pad, H, K, causal,
                            window, s);
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, S_pad, H, K, causal,
                            window, s);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, S_pad, H, K, causal,
                             window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
