// wire_encode: the fused int8 wire encode with error feedback, for sm_90a.
//
//   coded   = sum_p w[p] * g[p, :] + err              (f32)
//   scale   = max(max|coded|, 1e-12) * f32(1/127)      (a multiply)
//   q       = clip(round_half_even(coded / scale), -127, 127)   (int8)
//   new_err = coded - q * scale, rounded once
//
// Replaces the TPU kernel src/repro/kernels/wire.py:
// coded_encode_int8_pallas (pallas_call body _encode_kernel).  It is the
// spmd backend's per-worker encode on the compressed wire: one call a
// worker a step, its q stacked for the int8 decode (coded_reduce.cu's
// int8 -> f32 instantiation).
//
// Bound: memory.  At the main path's f32 (P, D) input the least the work
// must move is g, err, q and new_err once each, (4P + 9) * D bytes; it does
// 2P + 6 flops an element, far below the H100's ridge.
//
// Design.  The global scale needs max|coded| over all of D before the
// first int8 byte can be written.  The Pallas kernel swept its grid twice
// in order (phase 0 folds the max in VMEM scratch, phase 1 recomputes the
// tile from g and emits).  Hopper blocks run in no order and the chip
// cannot hold a (D,) f32 tensor at D ~ 3.6e8, so this is two launches on
// the caller's stream:
//
//   A  reduce + err (the loop of coded_accum.cuh, the same order and
//      roundings as coded_reduce.cu), write coded into new_err, fold
//      |coded| into a block max and one atomicMax per block on the uint32
//      bits of a 4-byte scratch the wrapper zeroed;
//   B  read the max, compute scale, quantize each coded value and write q
//      and the residual over coded in new_err.
//
// That moves (4P + 17) * D bytes: coded makes one round trip through
// new_err instead of re-reading g.  new_err may alias err: in pass A each
// thread reads err[d] before it writes coded[d], and no other thread
// touches d, so err and new_err carry no __restrict__.
//
// Bit contract (held against the numpy oracle encode_int8_oracle_np):
//   - the reduce is coded_accum::accumulate, then one separate f32 add;
//   - |coded| as bits: clearing the sign bit keeps NaN above +inf
//     (0x7fc00000 > 0x7f800000), so unsigned max propagates NaN the way
//     np.max does (fmaxf would drop it), and the floor step keeps it too;
//   - scale is __fmul_rn by static_cast<float>(1.0 / 127.0), the bits of
//     np.float32(1.0 / 127.0) (exported for the tests);
//   - coded / scale is __fdiv_rn (IEEE), rounded by rintf (half to even;
//     roundf would round half away from zero);
//   - the residual is one __fmaf_rn(-q, scale, coded): the exact residual
//     rounded once;
//   - intrinsics everywhere, so no -fmad contraction can change a rounding.
//     Build without --use_fast_math.
// Lanes past D are never visited, so they take no part in the max.  The
// kernel allocates nothing and launches on the caller's stream; the launch
// error is returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "coded_accum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;
constexpr float kEpsScale = 1e-12f;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

// dtype codes shared with the Python wrapper
enum : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(x) & 0x7fffffffu; }

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

// Pass A: coded = reduce + err into `coded` (the new_err buffer), and the
// grid's max of |coded| as bits into *mx_bits.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
encode_coded_max_kernel(const T* __restrict__ g, const float* __restrict__ w,
                        const float* err, float* coded, int P, long long D,
                        unsigned* __restrict__ mx_bits) {
  extern __shared__ float w_s[];
  __shared__ unsigned warp_max[kWarps];
  for (int p = threadIdx.x; p < P; p += blockDim.x) w_s[p] = w[p];
  __syncthreads();

  unsigned local = 0u;
  const long long n_work = D / VEC;  // VEC == 1 whenever the vector path is off
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_work; v += stride) {
    const long long col = v * VEC;
    float acc[VEC];
    coded_accum::accumulate<T, VEC>(g + col, w_s, P, D, acc);
    float c[VEC];
    load_f32<VEC>(err + col, c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      c[j] = __fadd_rn(acc[j], c[j]);
      local = max(local, abs_bits(c[j]));
    }
    store_f32<VEC>(coded + col, c);
  }
  // every thread of the block reaches here: warp max, then block max, then
  // one atomic per block
  local = __reduce_max_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned m = warp_max[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) m = max(m, warp_max[i]);
    atomicMax(mx_bits, m);
  }
}

// Pass B: scale from the max; q and the residual from coded, in place.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
encode_quantize_kernel(float* coded_err, int8_t* __restrict__ q, float* __restrict__ scale_out,
                       const unsigned* __restrict__ mx_bits, long long D) {
  const float mx = __uint_as_float(*mx_bits);
  const float floored = (mx >= kEpsScale || isnan(mx)) ? mx : kEpsScale;
  const float scale = __fmul_rn(floored, kInv127);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;

  const long long n_work = D / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_work; v += stride) {
    const long long col = v * VEC;
    float c[VEC];
    load_f32<VEC>(coded_err + col, c);
    alignas(VEC) int8_t qv[VEC];
    float r[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t = fminf(fmaxf(rintf(__fdiv_rn(c[j], scale)), -127.0f), 127.0f);
      qv[j] = static_cast<int8_t>(static_cast<int>(t));
      r[j] = __fmaf_rn(-t, scale, c[j]);
    }
    store_f32<VEC>(coded_err + col, r);
    if constexpr (VEC == 1) {
      q[col] = qv[0];
    } else {
      static_assert(VEC == 4, "four int8 lanes, one 4-byte store");
      *reinterpret_cast<uint32_t*>(q + col) = *reinterpret_cast<const uint32_t*>(qv);
    }
  }
}

unsigned grid_for(long long n_work) {
  long long blocks = (n_work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

bool aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <typename T>
cudaError_t launch_coded_max(const void* g, const float* w, const float* err, float* coded,
                             int P, long long D, unsigned* mx, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = (D % VEC == 0) && aligned(g, 16) && aligned(err, 16) && aligned(coded, 16);
  const size_t smem = static_cast<size_t>(P) * sizeof(float);
  if (vec) {
    encode_coded_max_kernel<T, VEC><<<grid_for(D / VEC), kThreads, smem, stream>>>(
        static_cast<const T*>(g), w, err, coded, P, D, mx);
  } else {
    encode_coded_max_kernel<T, 1><<<grid_for(D), kThreads, smem, stream>>>(
        static_cast<const T*>(g), w, err, coded, P, D, mx);
  }
  return cudaGetLastError();
}

cudaError_t launch_quantize(float* coded_err, int8_t* q, float* scale, const unsigned* mx,
                            long long D, cudaStream_t stream) {
  const bool vec = (D % 4 == 0) && aligned(coded_err, 16) && aligned(q, 4);
  if (vec) {
    encode_quantize_kernel<4><<<grid_for(D / 4), kThreads, 0, stream>>>(coded_err, q, scale, mx, D);
  } else {
    encode_quantize_kernel<1><<<grid_for(D), kThreads, 0, stream>>>(coded_err, q, scale, mx, D);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wire_encode_max_rows() { return coded_accum::kMaxRows; }

// The format's constants as this library computes with them.
float wire_encode_inv127() { return kInv127; }
float wire_encode_eps() { return kEpsScale; }

// g: (P, D) contiguous, dtype in_code (f32 or bf16); w: (P,) f32;
// err: (D,) f32; new_err: (D,) f32, equal to err or disjoint from it;
// q: (D,) int8; scale: one f32; mx_scratch: 4 bytes, zeroed by the caller.
// Returns the first launch's cudaError_t (0 on success).
int wire_encode_launch(const void* g, const void* w, const void* err, void* new_err, void* q,
                       void* scale, void* mx_scratch, long long P, long long D, int in_code,
                       void* stream) {
  if (P < 1 || D < 1 || P > coded_accum::kMaxRows) return cudaErrorInvalidValue;
  const int p = static_cast<int>(P);
  const float* wf = static_cast<const float*>(w);
  const float* ef = static_cast<const float*>(err);
  float* cf = static_cast<float*>(new_err);
  unsigned* mx = static_cast<unsigned*>(mx_scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_code == kF32)
    e = launch_coded_max<float>(g, wf, ef, cf, p, D, mx, s);
  else if (in_code == kBF16)
    e = launch_coded_max<__nv_bfloat16>(g, wf, ef, cf, p, D, mx, s);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  return launch_quantize(cf, static_cast<int8_t*>(q), static_cast<float*>(scale), mx, D, s);
}

}  // extern "C"
