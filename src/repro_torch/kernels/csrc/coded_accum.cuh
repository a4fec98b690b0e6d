// The coded reduce's inner loop, shared by coded_reduce.cu and
// wire_encode.cu so that both kernels accumulate sum_p w[p] * g[p, col] in
// the same order with the same roundings: acc starts at 0.0f, then one
// fmaf per row, p = 0 .. P-1.  The fused int8 encode is held bit-equal to
// an oracle whose reduce IS coded_reduce (f32 out), so the two must never
// drift apart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace coded_accum {

// Largest P: the weights live in 48 KiB of dynamic shared memory.
constexpr int kMaxRows = 48 * 1024 / static_cast<int>(sizeof(float));

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// acc[j] = sum_p w_s[p] * src[p * D + j] for j < VEC, in f32.  VEC == 1
// loads one element a row; otherwise one 16-byte load a row, which needs
// src 16-byte aligned and D a multiple of VEC.
template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const T* __restrict__ src, const float* w_s, int P,
                                           long long D, float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int p = 0; p < P; ++p, src += D) {
    const float wp = w_s[p];
    if constexpr (VEC == 1) {
      acc[0] = fmaf(wp, to_f32(__ldg(src)), acc[0]);
    } else {
      static_assert(VEC * sizeof(T) == 16, "one 16-byte load per row");
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wp, to_f32(vals[j]), acc[j]);
    }
  }
}

}  // namespace coded_accum
