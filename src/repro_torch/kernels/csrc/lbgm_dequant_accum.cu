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
// Bound on an H100: bytes. Per payload entry the kernel must read a 4-byte
// index and a 1-byte value and read and write one 4-byte accumulator
// element (13 bytes), plus one 4-byte scale per (client, row), for a
// multiply and an add: far below the card's ratio of flops to HBM bytes.
// At the FCN's largest leaf (C 10, nb 16, block 65536, kb 627) that is
// 0.38 us counting only the accumulator elements the payload touches.
// This design moves every element of the accumulator (8 B each, 8.4 MB,
// 2.5 us at 3.35 TB/s) and buys with it a launch whose chain of dependent
// memory round trips is two (payload and segment in, segment out), where
// one CTA per row walking the clients had about 30.
//
// Design: the grid is nb x ceil(block / SEG) CTAs of 256 threads, each
// owning one segment of SEG = 4096 accumulator floats of one row (16 KB of
// shared memory): 256 CTAs for that leaf, against 16 rows. A CTA
//  1. stages its segment of the row into shared memory with cp.async
//     (16 bytes a thread where the row is aligned) and, at the same time,
//     loads into registers the row's payload of every client (index and
//     value; a client's kb entries spread over ceil(kb / 32) threads, 32
//     entries each, so no thread divides by kb) and each client's
//     coefficient: all loads independent, in flight together;
//  2. keeps the entries that fall in its segment, in per-client lists in
//     shared memory (an atomic slot per entry: order within a client does
//     not matter, its indices are unique within the row);
//  3. for c = 0 .. C - 1 in order applies client c's list to the segment,
//     with a __syncthreads() between clients, which keeps the clients'
//     order where two hit the same position;
//  4. writes the segment back.
// A row's payload of more than 8192 entries is taken in windows of whole
// clients (a client of more than 8192 entries in several), one more round
// trip each. No atomics touch the accumulator, and the result is the same
// bits on every run.
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
constexpr int SEG = 4096;                    // accumulator floats per CTA
constexpr int PER = 32;                      // payload entries per thread
constexpr int WIN = PER * DQ_THREADS;        // entries per window
constexpr int WIN_CLIENTS = DQ_THREADS;      // clients per window, at most
constexpr int SMEM = SEG * 4 + WIN * 4 + WIN_CLIENTS * 12;

// wire dtype codes shared with the Python wrapper
enum { QV_INT8 = 0, QV_E4M3 = 1 };

__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);  // exact; NaN stays NaN
}

template <typename Q>
__device__ __forceinline__ float widen_bits(uint32_t b) {
  const uint8_t u = (uint8_t)b;
  return widen(*reinterpret_cast<const Q*>(&u));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The window plan, the same for every row: a client's kb entries are
// spread over tpc threads, PER entries each (a client of more than WIN
// entries takes several windows of WIN); a window holds ncw clients.
struct Plan {
  int tpc, ncw, span;  // threads per client, clients per window, entries
                       // of one client per window (min(kb, WIN))
};

// acc: (nb, block) f32, updated in place; w, gscale: (C,) f32; idx:
// (C, nb, kb) int32 block-local; qv: (C, nb, kb) int8 / e4m3; scale:
// (C, nb, 1) f32. grid nb * nseg, one CTA per (row, segment).
template <typename Q>
__global__ void __launch_bounds__(DQ_THREADS)
    dequant_accum_kernel(float* __restrict__ acc, const float* __restrict__ w,
                         const float* __restrict__ gscale,
                         const int* __restrict__ idx,
                         const uint8_t* __restrict__ qv,
                         const float* __restrict__ scale, int C, int nb,
                         int block, int kb, int nseg, Plan plan) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* sacc = reinterpret_cast<float*>(smem);
  uint32_t* list = reinterpret_cast<uint32_t*>(sacc + SEG);  // per window
  int* cnt = reinterpret_cast<int*>(list + WIN);              // per client
  float* coef = reinterpret_cast<float*>(cnt + WIN_CLIENTS);
  int* on = reinterpret_cast<int*>(coef + WIN_CLIENTS);

  const int row = blockIdx.x / nseg;
  const int seg0 = (blockIdx.x % nseg) * SEG;
  const int len = min(SEG, block - seg0);
  float* arow = acc + (long long)row * block + seg0;
  const bool vec = (reinterpret_cast<uintptr_t>(arow) & 15) == 0;

  // 1a. the segment, asynchronously
  if (vec) {
    for (int i = 4 * threadIdx.x; i + 3 < len; i += 4 * DQ_THREADS)
      cp_async16(sacc + i, arow + i);
    for (int i = (len & ~3) + threadIdx.x; i < len; i += DQ_THREADS)
      cp_async4(sacc + i, arow + i);
  } else {
    for (int i = threadIdx.x; i < len; i += DQ_THREADS)
      cp_async4(sacc + i, arow + i);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  // this thread's client slot in a window and its first entry there
  const int cs = threadIdx.x / plan.tpc, tl = threadIdx.x % plan.tpc;
  for (int c_lo = 0; c_lo < C; c_lo += plan.ncw) {
    const int n_cl = min(plan.ncw, C - c_lo);
    for (int j0 = 0; j0 < kb; j0 += WIN) {
      const int jn = min(kb - j0, WIN);  // entries of each client here
      // 1b. this thread's entries and the window's coefficients
      const int c = c_lo + cs;
      const bool mine = cs < n_cl;
      const long long g0 = ((long long)c * nb + row) * kb + j0 + tl;
      int gi[PER];
      uint32_t gq[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int j = tl + u * plan.tpc;
        gi[u] = -1;
        gq[u] = 0;
        if (mine && j < jn) {
          gi[u] = __ldg(idx + g0 + (long long)u * plan.tpc);
          gq[u] = __ldg(qv + g0 + (long long)u * plan.tpc);
        }
      }
      if (threadIdx.x < n_cl) {
        const int cc = c_lo + threadIdx.x;
        const float wc = w[cc];
        cnt[threadIdx.x] = 0;
        coef[threadIdx.x] = __fmul_rn(__fmul_rn(wc, gscale[cc]),
                                      scale[(long long)cc * nb + row]);
        on[threadIdx.x] = wc > 0.f;
      }
      __syncthreads();  // counters zeroed; the previous window applied

      // 2. the entries in this segment, into their client's list
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        // outside the segment or the row (negative indices wrap): skipped
        const unsigned li = (unsigned)gi[u] - (unsigned)seg0;
        if (li < (unsigned)len) {
          const int slot = atomicAdd(cnt + cs, 1);
          list[cs * plan.span + slot] = li | (gq[u] << 16);
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();

      // 3. the clients in order
      for (int k = 0; k < n_cl; ++k) {
        const float cf = coef[k];
        const bool onk = on[k] != 0;
        const int n = cnt[k];
        for (int t = threadIdx.x; t < n; t += DQ_THREADS) {
          const uint32_t ent = list[k * plan.span + t];
          const int li = (int)(ent & 0xffffu);
          const float add =
              onk ? __fmul_rn(cf, widen_bits<Q>(ent >> 16)) : 0.f;
          sacc[li] = __fadd_rn(sacc[li], add);
        }
        __syncthreads();
      }
    }
  }

  // 4. the segment back
  if (vec) {
    for (int i = 4 * threadIdx.x; i + 3 < len; i += 4 * DQ_THREADS)
      *reinterpret_cast<float4*>(arow + i) =
          *reinterpret_cast<const float4*>(sacc + i);
    for (int i = (len & ~3) + threadIdx.x; i < len; i += DQ_THREADS)
      arow[i] = sacc[i];
  } else {
    for (int i = threadIdx.x; i < len; i += DQ_THREADS) arow[i] = sacc[i];
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
  const long long nseg = (block + SEG - 1) / SEG;
  if (nb * nseg > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(nb * nseg);
  const uint8_t* q = static_cast<const uint8_t*>(qv);
  Plan plan;
  plan.span = (int)(kb < WIN ? kb : WIN);
  plan.tpc = (plan.span + PER - 1) / PER;
  plan.ncw = DQ_THREADS / plan.tpc;
  cudaError_t e;
  if (qdtype == QV_INT8) {
    e = cudaFuncSetAttribute(dequant_accum_kernel<int8_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    dequant_accum_kernel<int8_t><<<grid, DQ_THREADS, SMEM, s>>>(
        acc, w, gscale, idx, q, scale, (int)C, (int)nb, (int)block, (int)kb,
        (int)nseg, plan);
  } else if (qdtype == QV_E4M3) {
    e = cudaFuncSetAttribute(dequant_accum_kernel<__nv_fp8_e4m3>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    dequant_accum_kernel<__nv_fp8_e4m3><<<grid, DQ_THREADS, SMEM, s>>>(
        acc, w, gscale, idx, q, scale, (int)C, (int)nb, (int)block, (int)kb,
        (int)nseg, plan);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
