// Fused dequantize + scatter-accumulate of C clients' quantized sparse
// payloads into one (nb, block) fp32 accumulator leaf, in place:
//
//   acc[row, idx_c] += [w_c > 0] ((w_c * gscale_c) * scale_c[row]) * f32(qv_c)
//
// clients folded strictly in order. qv is int8 or fp8 e4m3 (the wire
// dtype) and widens to fp32 inside the kernel, so no fp32 (C, nb, kb)
// payload is ever written.
//
// Replaces the TPU kernel lbgm_dequant_accum_pallas
// (src/repro/kernels/lbgm_sparse.py:324, body _dequant_accum_kernel :286).
//
// Bound on an H100: bytes. Per payload entry the kernel reads a 4-byte
// index and a 1-byte value and reads and writes one 4-byte accumulator
// element (13 bytes), plus one 4-byte scale per (client, row), for a
// multiply and an add: far below the card's ratio of flops to HBM bytes.
//
// Design: one CTA of 256 threads owns one accumulator row and walks the C
// clients in order, with a __syncthreads() between clients: two clients may
// hit the same position, so a row is never split across CTAs, and no
// atomics are needed (top-k indices are unique within one client's row, so
// the threads of one client step touch distinct elements). Each thread
// gathers, updates and scatters entries j, j + 256, ... of the client's
// row. The grid is nb CTAs: 16 for the FCN's largest leaf, far from
// filling 132 SMs. Batching every leaf of a chunk into one launch is later
// work.
//
// Arithmetic: coeff = __fmul_rn(__fmul_rn(w, gscale), scale), then
// __fadd_rn(cur, w > 0 ? __fmul_rn(coeff, q) : 0.f). The _rn intrinsics
// are never contracted into an FMA, so the kernel rounds the product and
// the sum separately, exactly as the plain PyTorch version
// (kernels/ref.py: lbgm_dequant_accum_ref) does on any device, and the two
// agree bit for bit. A phantom client (w = 0) may carry NaN values or a NaN
// gscale: the select drops its product, it is never multiplied by 0.
// The add still runs for it (cur + 0), as in the plain version.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int DQ_THREADS = 256;

// wire dtype codes shared with the Python wrapper
enum { QV_INT8 = 0, QV_E4M3 = 1 };

__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);  // exact; NaN stays NaN
}

template <typename Q>
__global__ void __launch_bounds__(DQ_THREADS)
    dequant_accum_kernel(float* __restrict__ acc, const float* __restrict__ w,
                         const float* __restrict__ gscale,
                         const int* __restrict__ idx, const Q* __restrict__ qv,
                         const float* __restrict__ scale, int C, int nb,
                         int block, int kb) {
  const int row = blockIdx.x;
  float* a = acc + (long long)row * block;
  for (int c = 0; c < C; ++c) {
    const float wc = w[c];
    const bool on = wc > 0.f;
    const float coeff =
        __fmul_rn(__fmul_rn(wc, gscale[c]), scale[(long long)c * nb + row]);
    const long long base = ((long long)c * nb + row) * kb;
    for (int j = threadIdx.x; j < kb; j += DQ_THREADS) {
      const int i = idx[base + j];
      if (i < 0 || i >= block) continue;  // never write outside the row
      const float add = on ? __fmul_rn(coeff, widen(qv[base + j])) : 0.f;
      a[i] = __fadd_rn(a[i], add);
    }
    // the next client may hit a position this one just wrote
    __syncthreads();
  }
}

// acc: (nb, block) f32, updated in place; w, gscale: (C,) f32; idx:
// (C, nb, kb) int32 block-local, unique within a row; qv: (C, nb, kb) bytes
// of dtype QV_INT8 or QV_E4M3; scale: (C, nb, 1) f32. All contiguous.
// Returns a cudaError_t.
extern "C" int lbgm_dequant_accum_launch(float* acc, const float* w,
                                         const float* gscale, const int* idx,
                                         const void* qv, int qdtype,
                                         const float* scale, long long C,
                                         long long nb, long long block,
                                         long long kb, void* stream) {
  if (C < 1 || nb < 1 || kb < 1 || kb > block || block > 0x7fffffffLL ||
      nb > 0x7fffffffLL || C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qdtype == QV_INT8)
    dequant_accum_kernel<int8_t><<<(unsigned)nb, DQ_THREADS, 0, s>>>(
        acc, w, gscale, idx, static_cast<const int8_t*>(qv), scale, (int)C,
        (int)nb, (int)block, (int)kb);
  else if (qdtype == QV_E4M3)
    dequant_accum_kernel<__nv_fp8_e4m3><<<(unsigned)nb, DQ_THREADS, 0, s>>>(
        acc, w, gscale, idx, static_cast<const __nv_fp8_e4m3*>(qv), scale,
        (int)C, (int)nb, (int)block, (int)kb);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
