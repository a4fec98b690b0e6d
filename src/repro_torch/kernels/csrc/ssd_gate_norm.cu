// ssd_gate_norm: the Mamba2 block's epilogue after the SSD scan, forward and
// backward, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the epilogue of
// src/repro/models/ssm.py:mamba_forward (the D skip, the SiLU gate and the
// gated RMSNorm) to XLA, which fuses it.  PyTorch runs the same chain eagerly
// as some fifteen kernels forward and twenty-seven backward, most of their
// traffic f32 copies of bf16 tensors; this pair reads each operand once and
// writes each result once.  Per row t (one token, d = H * P columns, head
// h = column / P), with the model's rounding points:
//
//   y1  = bf16(y + D[h] * xs)                 y f32, xs bf16
//   s   = bf16(silu(z))                       z bf16, silu = z / (1 + exp(-z))
//   g   = bf16(y1 * s)
//   r   = rsqrt(sum(g^2) / d + eps)           f32 over the row
//   out = bf16((g * r) * norm)                norm bf16
//
// and the backward from out's gradient go (straight through each rounding):
//
//   dn = go * norm;  dg = r * dn - g * r^3 * sum(dn * g) / d
//   dy  = dg * s                              (f32: the scan's gradient)
//   dxs = bf16(D[h] * dy);  dz = bf16(dg * y1 * sig * (1 + z * (1 - sig)))
//   dnorm = bf16(sum_t go * (g * r));  dD[h] = sum_{t, p in h} dy * xs
//
// Every product and sum of the forward is rounded where PyTorch's chain
// rounds it (__fmul_rn / __fadd_rn: no contraction into an FMA), so the
// output equals the chain's but where the row's sum of squares, taken in
// another order, moves r by an ulp.
//
// Bound: memory.  A few operations a byte, far below the H100's ~295 flops
// a byte: forward 10 bytes an element (y 4, xs 2, z 2 read; out 2 written),
// backward 18 (go 2, y 4, xs 2, z 2 read; dy 4, dxs 2, dz 2 written).  At a
// pass of the benchmark's mamba2 or granite cell (167.8 M elements) that is
// 0.50 and 0.90 ms at 3.35 TB/s.
//
// Design.  A row is reduced whole, so it lives in one block: threadIdx.x
// walks its columns in vectors of VEC elements (16-byte bf16 loads at
// VEC 8), ITEMS vectors a thread, all loaded before any is used;
// threadIdx.y holds ROWS rows a block where a row is narrower than 256
// threads.  The row's sums go through warp shuffles and one word of shared
// memory a warp, summed in a fixed order by every thread.  The wrapper
// (kernels/ssd_gate_norm.py:launch_shape) picks VEC from the row width, the
// head size and the operands' alignment, and the threads, ITEMS and ROWS
// from the row width: at most 16 elements a thread.  xs and z are read in
// place through their batch and row strides (views of the in-projection's
// output), y likewise.
//
// The forward keeps nothing: the backward recomputes y1, s, g and r from
// the saved operands.  Its first pass over a row holds xs, z, go and y1
// (all bf16 values) packed in registers across the row's reduction, and
// the second computes s and g from them again, rather than hold them too:
// fewer registers, more blocks an SM.  The parameter gradients have no atomics: the backward's
// blocks are persistent (as many as fit on the card at once), each keeps
// its columns' dnorm sums in shared memory and its heads' dD sums in
// registers across its rows, writes one partial row, and a second launch
// sums the partials of every block in a fixed order.  So two calls give
// the same bits.  The kernels allocate nothing and launch on the caller's
// stream; the launch error is returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kReduceCols = 32;   // columns a block of the partials' reduction
constexpr int kReduceSlices = 8;  // blocks' partials a column is split into

// One operand's layout: element (b, s, col) at b * sb + s * ss + col.
struct Rows {
  long long sb, ss;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC consecutive bf16 values as floats; the wrapper checked the alignment.
template <int VEC>
__device__ __forceinline__ void load_bf16(const bf16* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __bfloat162float(p[0]);
  } else {
    union {
      uint4 u4;
      uint2 u2;
      unsigned int u1;
      __nv_bfloat162 h[4];
    } pk;
    if constexpr (VEC == 8) pk.u4 = __ldg(reinterpret_cast<const uint4*>(p));
    if constexpr (VEC == 4) pk.u2 = __ldg(reinterpret_cast<const uint2*>(p));
    if constexpr (VEC == 2) pk.u1 = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __bfloat1622float2(pk.h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_bf16(bf16* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else {
    union {
      uint4 u4;
      uint2 u2;
      unsigned int u1;
      __nv_bfloat162 h[4];
    } pk;
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) pk.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if constexpr (VEC == 8) *reinterpret_cast<uint4*>(p) = pk.u4;
    if constexpr (VEC == 4) *reinterpret_cast<uint2*>(p) = pk.u2;
    if constexpr (VEC == 2) *reinterpret_cast<unsigned int*>(p) = pk.u1;
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  } else if constexpr (VEC == 2) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// s = bf16(silu(z)) as PyTorch's bf16 silu computes it, and 1 + exp(-z).
__device__ __forceinline__ float silu_bf16(float z, float& den) {
  den = __fadd_rn(1.0f, expf(-z));
  return round_bf16(__fdiv_rn(z, den));
}

// The row's values of g: y1 = bf16(y + D x), s = bf16(silu(z)), g = bf16(y1 s),
// each rounded as the model's chain rounds it.
__device__ __forceinline__ void gate(float y, float x, float z, float d_h, float& y1, float& s,
                                     float& g) {
  float den;
  y1 = round_bf16(__fadd_rn(y, __fmul_rn(d_h, x)));
  s = silu_bf16(z, den);
  g = round_bf16(__fmul_rn(y1, s));
}

// The sum of `v` over the threadIdx.x of this row (blockDim.x threads, a
// multiple of 32), the same bits in every thread of the row: a warp's
// shuffle tree, then the row's warps in order.  `red` holds kMaxWarps
// floats a row slot; every thread of the block must call it.
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  float* mine = red + threadIdx.y * kMaxWarps;
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < warps; ++w) s += mine[w];
  __syncthreads();  // `red` is free again for the next call
  return s;
}

template <int VEC, int ITEMS, int MAXT>
__global__ void __launch_bounds__(MAXT)
gate_norm_fwd_kernel(const float* __restrict__ y, const bf16* __restrict__ xs,
                     const bf16* __restrict__ z, const float* __restrict__ D,
                     const bf16* __restrict__ norm, bf16* __restrict__ out, Rows ly, Rows lx,
                     Rows lz, int T, int S, int d, int P, float inv_d, float eps) {
  __shared__ float red[kMaxWarps * kMaxWarps];
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = t < T;
  const long long b = live ? t / S : 0, s_ = live ? t % S : 0;
  const float* yr = y + b * ly.sb + s_ * ly.ss;
  const bf16* xr = xs + b * lx.sb + s_ * lx.ss;
  const bf16* zr = z + b * lz.sb + s_ * lz.ss;

  float yv[ITEMS][VEC], xv[ITEMS][VEC], zv[ITEMS][VEC];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int col = (it * blockDim.x + threadIdx.x) * VEC;
    if (live && col < d) {
      load_f32<VEC>(yr + col, yv[it]);
      load_bf16<VEC>(xr + col, xv[it]);
      load_bf16<VEC>(zr + col, zv[it]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) yv[it][e] = xv[it][e] = zv[it][e] = 0.0f;
    }
  }
  float g[ITEMS][VEC];
  float ss = 0.0f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int col = (it * blockDim.x + threadIdx.x) * VEC;
    const float d_h = live && col < d ? __ldg(D + col / P) : 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float y1, sv;
      gate(yv[it][e], xv[it][e], zv[it][e], d_h, y1, sv, g[it][e]);
      ss = fmaf(g[it][e], g[it][e], ss);
    }
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(row_sum(ss, red), inv_d), eps));
  if (!live) return;
  bf16* orow = out + t * d;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int col = (it * blockDim.x + threadIdx.x) * VEC;
    if (col >= d) continue;
    float w[VEC], o[VEC];
    load_bf16<VEC>(norm + col, w);
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(__fmul_rn(g[it][e], r), w[e]);
    store_bf16<VEC>(orow + col, o);
  }
}

// The two sums of the backward's row, as row_sum does one: (sum a, sum b).
__device__ __forceinline__ float2 row_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warps = blockDim.x >> 5;
  if (warps == 1) return make_float2(a, b);
  float2* mine = red + threadIdx.y * kMaxWarps;
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
  for (int w = 0; w < warps; ++w) {
    s.x += mine[w].x;
    s.y += mine[w].y;
  }
  __syncthreads();
  return s;
}

// N bf16 values in (N + 1) / 2 registers: the backward's state of a row
// across the row's reduction (xs, z and go as loaded, y1 as computed; all
// bf16 values, so holding them rounds nothing).  Value i of vector `it`
// lies at it * VEC + i.
template <int N>
struct Packed {
  __nv_bfloat162 h[(N + 1) / 2];

  template <int VEC>
  __device__ __forceinline__ void load(int it, const bf16* __restrict__ p) {
    if constexpr (VEC == 1) {
      set(it, __bfloat162float(p[0]));
    } else {
      union {
        uint4 u4;
        uint2 u2;
        unsigned int u1;
        __nv_bfloat162 h[4];
      } pk;
      if constexpr (VEC == 8) pk.u4 = __ldg(reinterpret_cast<const uint4*>(p));
      if constexpr (VEC == 4) pk.u2 = __ldg(reinterpret_cast<const uint2*>(p));
      if constexpr (VEC == 2) pk.u1 = __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
      for (int j = 0; j < VEC / 2; ++j) h[it * VEC / 2 + j] = pk.h[j];
    }
  }
  __device__ __forceinline__ void set(int i, float v) {
    const bf16 b = __float2bfloat16_rn(v);
    h[i >> 1] = (i & 1) ? __halves2bfloat162(__low2bfloat16(h[i >> 1]), b)
                        : __halves2bfloat162(b, __high2bfloat16(h[i >> 1]));
  }
  __device__ __forceinline__ float get(int i) const {
    return (i & 1) ? __high2float(h[i >> 1]) : __low2float(h[i >> 1]);
  }
};

// Persistent blocks: block k takes row groups k, k + gridDim.x, ...  Its
// partial dnorm (d floats) and dD (H floats) go to work[k * (d + H) ...].
// Dynamic shared memory: ROWS * d floats of dnorm sums, then ROWS * d / VEC
// floats for the dD sums of each vector at the end.  A row's first pass
// keeps xs, z, go and y1 (two bytes each an element); the second recomputes
// s and g from them, as the first computed them.
template <int VEC, int ITEMS, int MAXT>
__global__ void __launch_bounds__(MAXT)
gate_norm_bwd_kernel(const bf16* __restrict__ go, const float* __restrict__ y,
                     const bf16* __restrict__ xs, const bf16* __restrict__ z,
                     const float* __restrict__ D, const bf16* __restrict__ norm,
                     float* __restrict__ dy, bf16* __restrict__ dxs, bf16* __restrict__ dz,
                     float* __restrict__ work, Rows ly, Rows lx, Rows lz, int T, int S, int d,
                     int P, float inv_d, float eps) {
  extern __shared__ float acc_s[];
  __shared__ float2 red[kMaxWarps * kMaxWarps];
  constexpr int N = ITEMS * VEC;
  const int rows = blockDim.y;
  const int groups = (T + rows - 1) / rows;
  float* acc = acc_s + threadIdx.y * d;  // this row slot's dnorm sums
  float d_h[ITEMS], dD[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int col = (it * blockDim.x + threadIdx.x) * VEC;
    d_h[it] = col < d ? __ldg(D + col / P) : 0.0f;
    dD[it] = 0.0f;
    if (col < d) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[col + e] = 0.0f;
    }
  }

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long long t = static_cast<long long>(grp) * rows + threadIdx.y;
    const bool live = t < T;
    const long long b = live ? t / S : 0, s_ = live ? t % S : 0;
    const float* yr = y + b * ly.sb + s_ * ly.ss;
    const bf16* xr = xs + b * lx.sb + s_ * lx.ss;
    const bf16* zr = z + b * lz.sb + s_ * lz.ss;
    const bf16* gr = go + t * d;

    // pass 1: load, recompute y1 and g as the forward did, the row's two sums
    Packed<N> x_p, z_p, go_p, y1_p;
    float ss = 0.0f, dot = 0.0f;
    {
      float yv[ITEMS][VEC];
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int col = (it * blockDim.x + threadIdx.x) * VEC;
        if (live && col < d) {
          load_f32<VEC>(yr + col, yv[it]);
          x_p.template load<VEC>(it, xr + col);
          z_p.template load<VEC>(it, zr + col);
          go_p.template load<VEC>(it, gr + col);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            yv[it][e] = 0.0f;
            x_p.set(it * VEC + e, 0.0f);
            z_p.set(it * VEC + e, 0.0f);
            go_p.set(it * VEC + e, 0.0f);
          }
        }
      }
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int col = (it * blockDim.x + threadIdx.x) * VEC;
        float w[VEC];
        if (col < d) {
          load_bf16<VEC>(norm + col, w);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) w[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = it * VEC + e;
          float y1, sv, g;
          gate(yv[it][e], x_p.get(i), z_p.get(i), d_h[it], y1, sv, g);
          y1_p.set(i, y1);
          ss = fmaf(g, g, ss);
          dot = fmaf(go_p.get(i) * w[e], g, dot);
        }
      }
    }
    const float2 sums = row_sum2(ss, dot, red);
    const float r = rsqrtf(__fadd_rn(__fmul_rn(sums.x, inv_d), eps));
    const float k = r * r * r * sums.y * inv_d;

    // pass 2: the gradients of the row
    if (live) {
      float* dyr = dy + t * d;
      bf16* dxr = dxs + t * d;
      bf16* dzr = dz + t * d;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int col = (it * blockDim.x + threadIdx.x) * VEC;
        if (col >= d) continue;
        float w[VEC], o_dy[VEC], o_dx[VEC], o_dz[VEC];
        load_bf16<VEC>(norm + col, w);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = it * VEC + e;
          const float zz = z_p.get(i), y1 = y1_p.get(i), gov = go_p.get(i);
          float den;
          const float sv = silu_bf16(zz, den);  // s and g as gate() gave them
          const float g = round_bf16(__fmul_rn(y1, sv));
          const float sig = 1.0f / den;
          const float dg = r * (gov * w[e]) - g * k;
          o_dy[e] = dg * sv;
          o_dx[e] = d_h[it] * o_dy[e];
          o_dz[e] = dg * y1 * (sig * (1.0f + zz * (1.0f - sig)));
          acc[col + e] += gov * __fmul_rn(g, r);
          dD[it] = fmaf(o_dy[e], x_p.get(i), dD[it]);
        }
        store_f32<VEC>(dyr + col, o_dy);
        store_bf16<VEC>(dxr + col, o_dx);
        store_bf16<VEC>(dzr + col, o_dz);
      }
    }
  }

  // the block's partials: dnorm by column over its row slots, in order;
  // dD by head over its vectors and row slots, in order
  const int nv = d / VEC, H = d / P, vph = P / VEC;
  float* dv = acc_s + rows * d;  // rows * nv floats
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int v = it * blockDim.x + threadIdx.x;
    if (v < nv) dv[threadIdx.y * nv + v] = dD[it];
  }
  __syncthreads();
  float* part = work + static_cast<long long>(blockIdx.x) * (d + H);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthreads = blockDim.x * blockDim.y;
  for (int c = tid; c < d; c += nthreads) {
    float s = acc_s[c];
    for (int q = 1; q < rows; ++q) s += acc_s[q * d + c];
    part[c] = s;
  }
  for (int h = tid; h < H; h += nthreads) {
    float s = 0.0f;
    for (int j = 0; j < vph; ++j)
      for (int q = 0; q < rows; ++q) s += dv[q * nv + h * vph + j];
    part[d + h] = s;
  }
}

// dnorm[c] = bf16(sum_k work[k][c]) for c < d, dD[h] = sum_k work[k][d + h]:
// each column's blocks split into kReduceSlices strided slices, summed in
// order, then the slices in order.
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
gate_norm_reduce_kernel(const float* __restrict__ work, int blocks, int d, int H,
                        bf16* __restrict__ dnorm, float* __restrict__ dD) {
  __shared__ float part[kReduceSlices][kReduceCols];
  const int cols = d + H;
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  float s = 0.0f;
  if (c < cols)
    for (int k = threadIdx.y; k < blocks; k += kReduceSlices)
      s += work[static_cast<long long>(k) * cols + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || c >= cols) return;
  float total = 0.0f;
#pragma unroll
  for (int q = 0; q < kReduceSlices; ++q) total += part[q][threadIdx.x];
  if (c < d)
    dnorm[c] = __float2bfloat16_rn(total);
  else
    dD[c - d] = total;
}

template <int VEC>
size_t bwd_smem(int d, int rows) {
  return static_cast<size_t>(rows) * (d + d / VEC) * sizeof(float);
}

// The persistent backward's grid: as many blocks as fit on the card at once,
// at most one a row group.
template <int VEC, int ITEMS, int MAXT>
cudaError_t bwd_grid(int d, int tx, int rows, int T, int* grid) {
  const size_t smem = bwd_smem<VEC>(d, rows);
  cudaError_t err = cudaFuncSetAttribute(gate_norm_bwd_kernel<VEC, ITEMS, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gate_norm_bwd_kernel<VEC, ITEMS, MAXT>,
                                                      tx * rows, smem);
  if (err != cudaSuccess) return err;
  const int groups = (T + rows - 1) / rows;
  const int fit = (per_sm > 0 ? per_sm : 1) * sms;
  *grid = groups < fit ? groups : fit;
  return cudaSuccess;
}

struct Launch {
  const float* y;
  const bf16 *xs, *z;
  const float* D;
  const bf16* norm;
  Rows ly, lx, lz;
  int T, S, d, P;
  float eps;
  int tx, rows;
  cudaStream_t stream;
};

template <int VEC, int ITEMS, int MAXT>
cudaError_t fwd(const Launch& a, bf16* out) {
  const int groups = (a.T + a.rows - 1) / a.rows;
  gate_norm_fwd_kernel<VEC, ITEMS, MAXT><<<groups, dim3(a.tx, a.rows), 0, a.stream>>>(
      a.y, a.xs, a.z, a.D, a.norm, out, a.ly, a.lx, a.lz, a.T, a.S, a.d, a.P, 1.0f / a.d, a.eps);
  return cudaGetLastError();
}

template <int VEC, int ITEMS, int MAXT>
cudaError_t bwd(const Launch& a, const bf16* go, float* dy, bf16* dxs, bf16* dz, float* work,
                int grid, bf16* dnorm, float* dD) {
  int fit = 0;
  cudaError_t err = bwd_grid<VEC, ITEMS, MAXT>(a.d, a.tx, a.rows, a.T, &fit);
  if (err != cudaSuccess) return err;
  if (grid != fit) return cudaErrorInvalidValue;  // the work buffer was sized for another grid
  gate_norm_bwd_kernel<VEC, ITEMS, MAXT><<<grid, dim3(a.tx, a.rows), bwd_smem<VEC>(a.d, a.rows),
                                           a.stream>>>(go, a.y, a.xs, a.z, a.D, a.norm, dy, dxs, dz,
                                                 work, a.ly, a.lx, a.lz, a.T, a.S, a.d, a.P,
                                                 1.0f / a.d, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int H = a.d / a.P;
  const int blocks = (a.d + H + kReduceCols - 1) / kReduceCols;
  gate_norm_reduce_kernel<<<blocks, dim3(kReduceCols, kReduceSlices), 0, a.stream>>>(
      work, grid, a.d, H, dnorm, dD);
  return cudaGetLastError();
}

// The instantiations (VEC, ITEMS, the block's threads at most): at most 16
// elements a thread; blocks of 256 threads take any of them, and the wrapper
// gives a row 512 or 1024 threads only with 16 elements a thread.
#define GATE_NORM_SHAPES(X)                                                              \
  X(8, 1, 256) X(8, 2, 256) X(4, 1, 256) X(4, 2, 256) X(4, 4, 256) X(2, 1, 256)         \
  X(2, 2, 256) X(2, 4, 256) X(2, 8, 256) X(1, 1, 256) X(1, 2, 256) X(1, 4, 256)         \
  X(1, 8, 256) X(1, 16, 256) X(8, 2, 512) X(4, 4, 512) X(2, 8, 512) X(1, 16, 512)       \
  X(8, 2, 1024) X(4, 4, 1024) X(2, 8, 1024) X(1, 16, 1024)

// The instantiation's block bound for a launch of `threads` a block.
int max_threads(int threads) { return threads <= 256 ? 256 : threads <= 512 ? 512 : 1024; }

bool valid(int T, int S, int d, int P, int vec, int tx, int rows) {
  return T >= 1 && S >= 1 && T % S == 0 && P >= 1 && d % P == 0 && P % vec == 0 &&
         tx >= 32 && tx % 32 == 0 && rows >= 1 && tx * rows <= kMaxThreads;
}

}  // namespace

extern "C" {

// Forward.  y f32, xs and z bf16 read through their (batch, row) strides in
// elements with the columns contiguous; D (d / P,) f32; norm (d,) bf16; out
// (T, d) bf16 contiguous, T = B * S rows.  Launch shape from the wrapper:
// `vec` elements a load, `tx` threads along a row, `rows` rows a block,
// `items` vectors a thread.  Returns the cudaError_t of the launch.
int ssd_gate_norm_fwd_launch(const void* y, const void* xs, const void* z, const void* D,
                             const void* norm, void* out, long long y_sb, long long y_ss,
                             long long x_sb, long long x_ss, long long z_sb, long long z_ss,
                             int T, int S, int d, int P, float eps, int vec, int tx, int rows,
                             int items, void* stream) {
  if (!valid(T, S, d, P, vec, tx, rows)) return cudaErrorInvalidValue;
  const Launch a{static_cast<const float*>(y), static_cast<const bf16*>(xs),
                 static_cast<const bf16*>(z), static_cast<const float*>(D),
                 static_cast<const bf16*>(norm), Rows{y_sb, y_ss}, Rows{x_sb, x_ss},
                 Rows{z_sb, z_ss}, T, S, d, P, eps, tx, rows,
                 static_cast<cudaStream_t>(stream)};
  if (static_cast<long long>(tx) * items * vec < d) return cudaErrorInvalidValue;
  bf16* o = static_cast<bf16*>(out);
  const int mt = max_threads(tx * rows);
#define X(V, I, M) \
  if (vec == V && items == I && mt == M) return fwd<V, I, M>(a, o);
  GATE_NORM_SHAPES(X)
#undef X
  return cudaErrorInvalidValue;
}

// The backward's grid (its persistent blocks) at this shape, for the
// wrapper to size `work` (grid * (d + d / P) floats).  Returns the
// cudaError_t; the grid in *grid.
int ssd_gate_norm_bwd_grid(int T, int S, int d, int P, int vec, int tx, int rows, int items,
                           int* grid) {
  if (!valid(T, S, d, P, vec, tx, rows)) return cudaErrorInvalidValue;
  const int mt = max_threads(tx * rows);
#define X(V, I, M) \
  if (vec == V && items == I && mt == M) return bwd_grid<V, I, M>(d, tx, rows, T, grid);
  GATE_NORM_SHAPES(X)
#undef X
  return cudaErrorInvalidValue;
}

// Backward.  go (T, d) bf16 contiguous; y, xs, z, D, norm as the forward's;
// dy (T, d) f32, dxs and dz (T, d) bf16 contiguous; dD (d / P,) f32, dnorm
// (d,) bf16; work: the ssd_gate_norm_bwd_grid's grid * (d + d / P) floats.
// Two launches (the rows, then the partials' reduction).
int ssd_gate_norm_bwd_launch(const void* go, const void* y, const void* xs, const void* z,
                             const void* D, const void* norm, void* dy, void* dxs, void* dz,
                             void* dD, void* dnorm, void* work, long long y_sb, long long y_ss,
                             long long x_sb, long long x_ss, long long z_sb, long long z_ss,
                             int T, int S, int d, int P, float eps, int vec, int tx, int rows,
                             int items, int grid, void* stream) {
  if (!valid(T, S, d, P, vec, tx, rows) || grid < 1) return cudaErrorInvalidValue;
  if (static_cast<long long>(tx) * items * vec < d) return cudaErrorInvalidValue;
  const Launch a{static_cast<const float*>(y), static_cast<const bf16*>(xs),
                 static_cast<const bf16*>(z), static_cast<const float*>(D),
                 static_cast<const bf16*>(norm), Rows{y_sb, y_ss}, Rows{x_sb, x_ss},
                 Rows{z_sb, z_ss}, T, S, d, P, eps, tx, rows,
                 static_cast<cudaStream_t>(stream)};
  const bf16* g = static_cast<const bf16*>(go);
  float* fdy = static_cast<float*>(dy);
  bf16* fdx = static_cast<bf16*>(dxs);
  bf16* fdz = static_cast<bf16*>(dz);
  float* w = static_cast<float*>(work);
  bf16* dn = static_cast<bf16*>(dnorm);
  float* dd = static_cast<float*>(dD);
  const int mt = max_threads(tx * rows);
#define X(V, I, M) \
  if (vec == V && items == I && mt == M) return bwd<V, I, M>(a, g, fdy, fdx, fdz, w, grid, dn, dd);
  GATE_NORM_SHAPES(X)
#undef X
  return cudaErrorInvalidValue;
}

}  // extern "C"
