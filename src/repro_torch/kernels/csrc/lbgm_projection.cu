// LBGM projection: fp32 (<g,l>, ||g||^2, ||l||^2) per client over every
// leaf of a chunk, in one read of g and l and one kernel.
//
// Replaces the TPU kernels lbgm_projection_pallas and
// lbgm_projection_batched_pallas (src/repro/kernels/lbgm_projection.py:54
// and :112): those are the one-leaf case (B = 1 the unbatched form).
//
// Bound on an H100: bytes. The kernel does 6 flops per 2 elements read, far
// below the card's ratio of flops to HBM bytes, so the least time is
// 2 * B * sum(n) * sizeof(dtype) bytes over the HBM rate (3.35 TB/s).
//
// Design: a table of leaves (g and l pointers, the per-client length n, one
// dtype) passed by value as a kernel parameter; the grid covers every
// (client, leaf, tile of PROJ_TILE elements). Each thread issues all its
// loads of a tile (16 elements of g and of l: four 16-byte vectors each in
// fp32, two in bf16, or 16 scalars where a leaf's length or pointers do not
// allow vectors) before the first use, 32 KB in flight per CTA, and
// accumulates the three sums in fp32 registers; a fixed tree (common.cuh)
// gives the tile's partials. The CTA that draws a client's last ticket
// finishes the client: each leaf's tile partials in tile order, one warp a
// leaf, in the arithmetic of block_sum<256> over a CTA of 256 threads; then
// the leaves left to right in table order. So a leaf's sums
// do not depend on the other leaves of the call, and the result equals,
// bit for bit, the left-to-right sum of one-leaf calls. More leaves than the
// table holds take one launch per PROJ_MAX_LEAVES, each adding onto the
// last's result.
#include "common.cuh"

constexpr int PROJ_THREADS = 256;
constexpr int PROJ_PER_THREAD = 16;
constexpr long long PROJ_TILE = PROJ_THREADS * PROJ_PER_THREAD;
constexpr int PROJ_MAX_LEAVES = 64;

struct ProjLeaf {
  const void* g;
  const void* l;
  long long n;         // elements per client
  long long tile_off;  // the leaf's first tile among a client's tiles
  int tiles;
  int vec;  // 16-byte loads: n a multiple of the vector, both aligned
};

struct ProjTable {
  ProjLeaf leaf[PROJ_MAX_LEAVES];
  int count;
  int accumulate;  // add onto out (a previous launch's leaves)
  long long tiles;  // per client, over the table
};

// The (gl, gg, ll) sums of one thread's elements of tile t of a leaf row:
// VEC consecutive elements per load (VEC == 1: scalars), every load issued
// before the first use.
template <typename T, int VEC>
__device__ __forceinline__ void tile_sums(const T* __restrict__ g,
                                          const T* __restrict__ l,
                                          long long n, long long start,
                                          float& gl, float& gg, float& ll) {
  constexpr int NV = PROJ_PER_THREAD / VEC;
  float a[PROJ_PER_THREAD], c[PROJ_PER_THREAD];
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const long long i = start + ((long long)q * PROJ_THREADS + threadIdx.x) *
                                    VEC;
    const bool ok = i < n;
    if constexpr (VEC == 1) {
      a[q] = ok ? to_f32(g[i]) : 0.f;
      c[q] = ok ? to_f32(l[i]) : 0.f;
    } else if constexpr (sizeof(T) == 4) {
      static_assert(VEC == 4, "fp32 vector loads take 4 elements");
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x = ok ? *reinterpret_cast<const float4*>(g + i) : zero;
      const float4 y = ok ? *reinterpret_cast<const float4*>(l + i) : zero;
      a[4 * q] = x.x; a[4 * q + 1] = x.y; a[4 * q + 2] = x.z;
      a[4 * q + 3] = x.w;
      c[4 * q] = y.x; c[4 * q + 1] = y.y; c[4 * q + 2] = y.z;
      c[4 * q + 3] = y.w;
    } else {
      static_assert(VEC == 8, "bf16 vector loads take 8 elements");
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 x = ok ? *reinterpret_cast<const uint4*>(g + i) : zero;
      const uint4 y = ok ? *reinterpret_cast<const uint4*>(l + i) : zero;
      const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fx = __bfloat1622float2(hx[j]);
        const float2 fy = __bfloat1622float2(hy[j]);
        a[8 * q + 2 * j] = fx.x;
        a[8 * q + 2 * j + 1] = fx.y;
        c[8 * q + 2 * j] = fy.x;
        c[8 * q + 2 * j + 1] = fy.y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PROJ_PER_THREAD; ++j) {
    gl = fmaf(a[j], c[j], gl);
    gg = fmaf(a[j], a[j], gg);
    ll = fmaf(c[j], c[j], ll);
  }
}

// partials: [3][B][tab.tiles] (gl, gg, ll); tickets: (B,), zero between
// calls; out: [3][B]. grid: B * tab.tiles CTAs, client-major.
template <typename T>
__global__ void __launch_bounds__(PROJ_THREADS)
    proj_leaves_kernel(const __grid_constant__ ProjTable tab, int B,
                       float* __restrict__ partials, int* __restrict__ tickets,
                       float* __restrict__ out) {
  __shared__ float scratch[3 * PROJ_THREADS / 32];
  __shared__ float sums[3 * PROJ_MAX_LEAVES];
  __shared__ int last;
  const int b = blockIdx.x / tab.tiles;
  const long long tc = blockIdx.x % tab.tiles;  // tile among the client's
  int li = 0;
  while (li + 1 < tab.count && tab.leaf[li + 1].tile_off <= tc) ++li;
  const ProjLeaf& lf = tab.leaf[li];
  const long long t = tc - lf.tile_off;
  const T* g = static_cast<const T*>(lf.g) + b * lf.n;
  const T* l = static_cast<const T*>(lf.l) + b * lf.n;
  float gl = 0.f, gg = 0.f, ll = 0.f;
  constexpr int VECW = 16 / sizeof(T);
  if (lf.vec)
    tile_sums<T, VECW>(g, l, lf.n, t * PROJ_TILE, gl, gg, ll);
  else
    tile_sums<T, 1>(g, l, lf.n, t * PROJ_TILE, gl, gg, ll);
  block_sum3<PROJ_THREADS>(gl, gg, ll, scratch);
  const long long stride = (long long)B * tab.tiles;
  float* p = partials + (long long)b * tab.tiles;
  if (threadIdx.x == 0) {
    p[tc] = gl;
    p[stride + tc] = gg;
    p[2 * stride + tc] = ll;
    __threadfence();
    last = atomicAdd(&tickets[b], 1) == tab.tiles - 1;
  }
  __syncthreads();
  if (!last) return;

  // the client's last CTA: every leaf's three sums, one warp a leaf, then
  // the leaves in table order
  __threadfence();
  const int warp = threadIdx.x >> 5;
  for (int L = warp; L < tab.count; L += PROJ_THREADS / 32) {
    float s[3];
    warp_tree_sum256x3(p + tab.leaf[L].tile_off, stride, tab.leaf[L].tiles,
                       s);
    if ((threadIdx.x & 31) == 0)
      for (int q = 0; q < 3; ++q) sums[3 * L + q] = s[q];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int q = threadIdx.x;
    float acc = tab.accumulate ? out[q * B + b] : sums[q];
    for (int L = tab.accumulate ? 0 : 1; L < tab.count; ++L)
      acc = acc + sums[3 * L + q];
    out[q * B + b] = acc;
  }
  if (threadIdx.x == 0) tickets[b] = 0;  // for the next call
}

extern "C" long long lbgm_projection_tile() { return PROJ_TILE; }

// count leaves: g[i], l[i] (B, n[i]) contiguous, all of dtype DT_F32 or
// DT_BF16; vec[i] != 0 asks for 16-byte loads (the caller guarantees n[i] a
// multiple of 16 / sizeof(dtype) and 16-byte aligned g[i] and l[i]).
// partials: 3 * B * sum_i ceil(n[i] / PROJ_TILE) floats of scratch;
// tickets: B ints, zero, left zero; out: [3][B] floats (gl, gg, ll), the
// sums over the leaves in order. One launch per PROJ_MAX_LEAVES leaves.
// Returns a cudaError_t.
extern "C" int lbgm_projection_launch(const void* const* g,
                                      const void* const* l,
                                      const long long* n, const int* vec,
                                      int count, int dtype, long long B,
                                      float* partials, int* tickets,
                                      float* out, void* stream) {
  if (B < 1 || count < 1 || (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < count; first += PROJ_MAX_LEAVES) {
    ProjTable tab = {};
    tab.count = count - first < PROJ_MAX_LEAVES ? count - first
                                                : PROJ_MAX_LEAVES;
    tab.accumulate = first > 0;
    for (int i = 0; i < tab.count; ++i) {
      const int k = first + i;
      if (n[k] < 1) return cudaErrorInvalidValue;
      ProjLeaf& lf = tab.leaf[i];
      lf.g = g[k];
      lf.l = l[k];
      lf.n = n[k];
      lf.vec = vec[k];
      lf.tile_off = tab.tiles;
      lf.tiles = (int)((n[k] + PROJ_TILE - 1) / PROJ_TILE);
      tab.tiles += lf.tiles;
    }
    if (B * tab.tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(B * tab.tiles);
    if (dtype == DT_F32)
      proj_leaves_kernel<float><<<grid, PROJ_THREADS, 0, s>>>(
          tab, (int)B, partials, tickets, out);
    else
      proj_leaves_kernel<__nv_bfloat16><<<grid, PROJ_THREADS, 0, s>>>(
          tab, (int)B, partials, tickets, out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
