// LBGM projection: fp32 (<g,l>, ||g||^2, ||l||^2) per row of a (B, n)
// stack, in one read of g and l.
//
// Replaces the TPU kernels lbgm_projection_pallas and
// lbgm_projection_batched_pallas (src/repro/kernels/lbgm_projection.py:54
// and :112). B = 1 serves the unbatched form.
//
// Bound on an H100: bytes. The kernel does 6 flops per 2 elements read, far
// below the card's ratio of flops to HBM bytes, so the least time is
// 2 * B * n * sizeof(dtype) bytes over the HBM rate (3.35 TB/s).
//
// Design: a grid of B * tiles CTAs of 256 threads. Each CTA reads one tile
// of PROJ_TILE elements of g and l with 16-byte vector loads (4 fp32 or
// 8 bf16 per load) where the row length and the pointers allow it, and
// accumulates the three sums in fp32 registers. It reduces them in a fixed
// tree (common.cuh) into three partials. A second launch (row_sum_kernel)
// adds each row's partials in tile order, so the result is the same on
// every run. A tile of 8192 elements gives the FCN's largest leaf
// (fc1/w, n = 100,352) 13 CTAs per client, about one wave on 132 SMs at a
// chunk of 10 clients.
#include "common.cuh"

constexpr int PROJ_THREADS = 256;
constexpr long long PROJ_TILE = 8192;

// Loads VEC consecutive elements starting at p[i] as fp32. VEC > 1 needs
// p + i aligned to 16 bytes.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, long long i,
                                         float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = to_f32(p[i]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "fp32 vector loads take 4 elements");
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    static_assert(VEC == 8, "bf16 vector loads take 8 elements");
    const uint4 v = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[2 * j] = f.x;
      o[2 * j + 1] = f.y;
    }
  }
}

// partials: [3][B][tiles] (gl, gg, ll).
template <typename T, int VEC>
__global__ void __launch_bounds__(PROJ_THREADS)
    proj_partial_kernel(const T* __restrict__ g, const T* __restrict__ l,
                        long long n, long long tiles, long long B,
                        float* __restrict__ partials) {
  __shared__ float scratch[PROJ_THREADS / 32];
  const long long b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const T* gr = g + b * n;
  const T* lr = l + b * n;
  const long long start = t * PROJ_TILE;
  const long long end = min(n, start + PROJ_TILE);
  float gl = 0.f, gg = 0.f, ll = 0.f;
  for (long long i = start + (long long)threadIdx.x * VEC; i < end;
       i += (long long)PROJ_THREADS * VEC) {
    float a[VEC], c[VEC];
    load_vec<T, VEC>(gr, i, a);
    load_vec<T, VEC>(lr, i, c);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      gl = fmaf(a[j], c[j], gl);
      gg = fmaf(a[j], a[j], gg);
      ll = fmaf(c[j], c[j], ll);
    }
  }
  gl = block_sum<PROJ_THREADS>(gl, scratch);
  gg = block_sum<PROJ_THREADS>(gg, scratch);
  ll = block_sum<PROJ_THREADS>(ll, scratch);
  if (threadIdx.x == 0) {
    const long long stride = B * tiles, o = b * tiles + t;
    partials[o] = gl;
    partials[stride + o] = gg;
    partials[2 * stride + o] = ll;
  }
}

template <typename T, int VEC>
static cudaError_t launch_partials(const void* g, const void* l, long long B,
                                   long long n, long long tiles,
                                   float* partials, cudaStream_t s) {
  proj_partial_kernel<T, VEC><<<(unsigned)(B * tiles), PROJ_THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(l), n, tiles, B,
      partials);
  return cudaGetLastError();
}

extern "C" long long lbgm_projection_tile() { return PROJ_TILE; }

// g, l: (B, n) contiguous, dtype DT_F32 or DT_BF16. vec != 0 asks for
// 16-byte loads: the caller guarantees n % (16 / sizeof(dtype)) == 0 and
// 16-byte aligned g and l. partials: 3 * B * ceil(n / PROJ_TILE) floats of
// scratch; out: [3][B] floats (gl, gg, ll). Returns a cudaError_t.
extern "C" int lbgm_projection_launch(const void* g, const void* l, int dtype,
                                      long long B, long long n, int vec,
                                      float* partials, float* out,
                                      void* stream) {
  if (B < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + PROJ_TILE - 1) / PROJ_TILE;
  if (B * tiles > 0x7fffffffLL || 3 * B > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == DT_F32)
    e = vec ? launch_partials<float, 4>(g, l, B, n, tiles, partials, s)
            : launch_partials<float, 1>(g, l, B, n, tiles, partials, s);
  else if (dtype == DT_BF16)
    e = vec ? launch_partials<__nv_bfloat16, 8>(g, l, B, n, tiles, partials, s)
            : launch_partials<__nv_bfloat16, 1>(g, l, B, n, tiles, partials, s);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  row_sum_kernel<<<(unsigned)(3 * B), ROW_SUM_THREADS, 0, s>>>(partials, out,
                                                              tiles);
  return cudaGetLastError();
}
