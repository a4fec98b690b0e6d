// coded_reduce: out[d] = sum_p w[p] * g[p, d], f32 accumulation, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/coded_reduce.py:
// coded_reduce_pallas (pallas_call body _coded_reduce_kernel, reduce step
// _chunk_contrib).  It is the spmd backend's per-worker encode
// g~_w = sum_s coeff[w, s] * g_s over the (n_slots, D) slot-gradient stack,
// and the master decode sum_w (a_w / k) * g~_w over the (m, D) coded stack.
//
// Bound: memory.  Each weight is used once per element (2 flops per
// P*itemsize bytes read), far below the H100's ~295 flops/byte ridge, so
// the least time is (P*D*itemsize + D*out_itemsize) / 3.35 TB/s.
//
// Design.  The Pallas kernel swept P in chunks of 128 along a sequential
// grid axis with a VMEM scratch accumulator.  Hopper blocks run in
// parallel and in no order, so that axis becomes a loop inside the thread:
// each thread owns VEC consecutive columns, keeps VEC f32 accumulators in
// registers and walks all P rows, so no partial sum ever leaves the chip
// and the output is written once.  The weights (P floats) are staged in
// shared memory.  Loads are 16 bytes a thread (4 f32, 8 bf16, 16 int8),
// consecutive threads on consecutive vectors; this needs every row to start
// 16-byte aligned (D * itemsize % 16 == 0 and aligned bases).  When it does
// not, the same loop runs with VEC = 1: one element a thread, which also
// covers the ragged end of D.  A grid-stride loop covers any D.
//
// Launch shape.  coded_reduce_launch uses the default shape (256 threads,
// blocks = ceil(n_work / 256) capped at 16 a SM).  coded_reduce_launch_shaped
// takes the threads (128, 256 or 512, each its own instantiation with
// matching launch bounds) and the block cap, which kernels/autotune.py's
// best_launch picks by measurement.  The shape moves no value: each column
// is summed by one thread over p = 0 .. P-1 whatever thread owns it, so
// every shape gives the default's bits.
//
// Every row is multiplied in, whatever its weight: a NaN weight must give
// NaN where it multiplies (the trainer's poisoned-payload contract), and
// 0 * NaN = NaN is kept.  The kernel allocates nothing and launches on the
// caller's stream; the launch error is returned to the caller.  The loop
// over P lives in coded_accum.cuh, shared with the fused int8 encode
// (wire_encode.cu), so both sum in one order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "coded_accum.cuh"

namespace {

constexpr int kThreads = 256;        // the default launch shape
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM on H100

// dtype codes shared with the Python wrapper
enum : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename OutT>
__device__ __forceinline__ OutT from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, typename OutT, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
coded_reduce_kernel(const T* __restrict__ g, const float* __restrict__ w,
                    OutT* __restrict__ out, int P, long long D) {
  extern __shared__ float w_s[];
  for (int p = threadIdx.x; p < P; p += blockDim.x) w_s[p] = w[p];
  __syncthreads();

  const long long n_work = D / VEC;  // VEC == 1 whenever D % VEC != 0
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n_work; v += stride) {
    const long long col = v * VEC;
    float acc[VEC];
    coded_accum::accumulate<T, VEC>(g + col, w_s, P, D, acc);
    if constexpr (VEC == 1) {
      out[col] = from_f32<OutT>(acc[0]);
    } else {
      // VEC * sizeof(OutT) is 16 or 64 bytes: store as 16-byte words
      constexpr int kWords = VEC * static_cast<int>(sizeof(OutT)) / 16;
      alignas(16) OutT o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = from_f32<OutT>(acc[j]);
      const uint4* words = reinterpret_cast<const uint4*>(o);
      uint4* dst = reinterpret_cast<uint4*>(out + col);
#pragma unroll
      for (int j = 0; j < kWords; ++j) dst[j] = words[j];
    }
  }
}

template <typename T, typename OutT, int THREADS>
cudaError_t launch_shaped(const void* g, const float* w, void* out, int P, long long D,
                          int max_blocks, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = (D % VEC == 0) &&
                       (reinterpret_cast<std::uintptr_t>(g) % 16 == 0) &&
                       (reinterpret_cast<std::uintptr_t>(out) % 16 == 0);
  const long long n_work = aligned ? D / VEC : D;
  long long blocks = (n_work + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const size_t smem = static_cast<size_t>(P) * sizeof(float);
  if (aligned) {
    coded_reduce_kernel<T, OutT, VEC, THREADS>
        <<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
            static_cast<const T*>(g), w, static_cast<OutT*>(out), P, D);
  } else {
    coded_reduce_kernel<T, OutT, 1, THREADS>
        <<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
            static_cast<const T*>(g), w, static_cast<OutT*>(out), P, D);
  }
  return cudaGetLastError();
}

template <typename T, typename OutT>
cudaError_t launch_typed(const void* g, const float* w, void* out, int P, long long D,
                         int max_blocks, int threads, cudaStream_t stream) {
  switch (threads) {
    case 128: return launch_shaped<T, OutT, 128>(g, w, out, P, D, max_blocks, stream);
    case 256: return launch_shaped<T, OutT, 256>(g, w, out, P, D, max_blocks, stream);
    case 512: return launch_shaped<T, OutT, 512>(g, w, out, P, D, max_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest P the kernel takes: the weights live in 48 KiB of shared memory.
int coded_reduce_max_rows() { return coded_accum::kMaxRows; }

// g: (P, D) contiguous, dtype in_code; w: (P,) f32; out: (D,) dtype out_code.
// out_code is f32 or in_code (int8 input takes f32 output only).  The
// launch takes `threads` (128, 256 or 512) a block and at most
// `max_blocks` blocks.  Returns the cudaError_t of the launch (0 on
// success).
int coded_reduce_launch_shaped(const void* g, const void* w, void* out, long long P,
                               long long D, int in_code, int out_code, int max_blocks,
                               int threads, void* stream) {
  if (P < 1 || D < 1 || P > coded_reduce_max_rows() || max_blocks < 1)
    return cudaErrorInvalidValue;
  const int p = static_cast<int>(P);
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code == kF32 && out_code == kF32)
    return launch_typed<float, float>(g, wf, out, p, D, max_blocks, threads, s);
  if (in_code == kBF16 && out_code == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(g, wf, out, p, D, max_blocks, threads, s);
  if (in_code == kBF16 && out_code == kF32)
    return launch_typed<__nv_bfloat16, float>(g, wf, out, p, D, max_blocks, threads, s);
  if (in_code == kI8 && out_code == kF32)
    return launch_typed<int8_t, float>(g, wf, out, p, D, max_blocks, threads, s);
  return cudaErrorInvalidValue;
}

// The default launch shape: every caller but impl="best" (the spmd encode
// and decode, the int8 wire's decode).
int coded_reduce_launch(const void* g, const void* w, void* out, long long P, long long D,
                        int in_code, int out_code, void* stream) {
  return coded_reduce_launch_shaped(g, w, out, P, D, in_code, out_code, kMaxBlocks, kThreads,
                                    stream);
}

// The default launch shape, for the Python wrapper: {max_blocks, threads}.
void coded_reduce_default_launch(int* shape) {
  shape[0] = kMaxBlocks;
  shape[1] = kThreads;
}

}  // extern "C"
