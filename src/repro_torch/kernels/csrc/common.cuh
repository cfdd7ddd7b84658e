// Helpers shared by the LBGM decision kernels (sm_90a).
//
// Every reduction here runs in a fixed order (warp shuffles, then one warp
// over the per-warp partials), never with float atomics, so a kernel
// returns the same bits on every run. A sum across CTAs is finished in the
// same kernel by the CTA that draws the last ticket (an integer atomic
// after a __threadfence), which adds the other CTAs' partials in a fixed
// order and resets its ticket for the next call.
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

// block_sum<NT> of three floats at once: the same tree for each, one pair
// of barriers for the three. Valid in thread 0.
template <int NT>
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c,
                                           float* scratch /* 3 * NT / 32 */) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
    scratch[warp] = a;
    scratch[NT / 32 + warp] = b;
    scratch[2 * NT / 32 + warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    a = (lane < NT / 32) ? scratch[lane] : 0.f;
    b = (lane < NT / 32) ? scratch[NT / 32 + lane] : 0.f;
    c = (lane < NT / 32) ? scratch[2 * NT / 32 + lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
  }
  __syncthreads();  // scratch may be reused after this
}

// The three sums p[q * stride + c] over c < cols (q = 0, 1, 2), by ONE
// warp, each in exactly the arithmetic of a CTA of 256 threads in which
// thread t adds p[t], p[t + 256], ... from 0 and the CTA then reduces with
// block_sum<256>: the eight virtual warps' shuffle trees, then the tree
// over their eight sums. Valid in every lane. Loads bypass L1 (`__ldcg`):
// the partials were written by other CTAs of the same launch.
__device__ __forceinline__ void warp_tree_sum256x3(const float* p,
                                                   long long stride,
                                                   long long cols,
                                                   float (&out)[3]) {
  const int lane = threadIdx.x & 31;
  float mine[3] = {0.f, 0.f, 0.f};  // lane w < 8: virtual warp w's sums
  for (int w = 0; w < 8 && (long long)w * 32 < cols; ++w) {
    float v[3] = {0.f, 0.f, 0.f};
    for (long long c = w * 32 + lane; c < cols; c += 256) {
#pragma unroll
      for (int q = 0; q < 3; ++q) v[q] += __ldcg(p + q * stride + c);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
      v[q] = __shfl_sync(0xffffffffu, v[q], 0);
      if (lane == w) mine[q] = v[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float r = lane < 8 ? mine[q] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      r += __shfl_down_sync(0xffffffffu, r, off);
    out[q] = __shfl_sync(0xffffffffu, r, 0);
  }
}

// ------------------------------------------------- mbarrier, bulk copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbarrier_expect_tx(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts seconds traps, so a lost copy is a launch error, not a hung
// card.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 28)) __trap();
  }
}

// The TMA's 1-D bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global to this CTA's shared memory, completing on
// the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------ cluster barrier

// All threads of every CTA of the cluster: arrive (release: this CTA's
// shared and distributed-shared writes become visible) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
