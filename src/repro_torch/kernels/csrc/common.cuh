// Helpers shared by the LBGM decision kernels (sm_90a).
//
// Every reduction here runs in a fixed order (warp shuffles, then one warp
// over the per-warp partials, then a second launch over the per-CTA
// partials), never with atomics, so a kernel returns the same bits on
// every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of one float per thread over a CTA of NT threads in a fixed tree
// order. The result is valid in thread 0. `scratch` holds NT / 32 floats.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.f;
  if (warp == 0) {
    r = (lane < NT / 32) ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      r += __shfl_down_sync(0xffffffffu, r, off);
  }
  __syncthreads();  // scratch may be reused after this
  return r;
}

constexpr int ROW_SUM_THREADS = 256;

// out[r] = sum_c in[r * cols + c]: one CTA per row, fixed order. The
// second stage of every cross-CTA reduction in these kernels.
__global__ void __launch_bounds__(ROW_SUM_THREADS)
    row_sum_kernel(const float* __restrict__ in, float* __restrict__ out,
                   long long cols) {
  __shared__ float scratch[ROW_SUM_THREADS / 32];
  const float* row = in + (long long)blockIdx.x * cols;
  float s = 0.f;
  for (long long c = threadIdx.x; c < cols; c += ROW_SUM_THREADS) s += row[c];
  s = block_sum<ROW_SUM_THREADS>(s, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}
