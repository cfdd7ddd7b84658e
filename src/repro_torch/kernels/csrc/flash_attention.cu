// Flash attention forward for fp32 inputs: causal (+ optional sliding
// window) GQA attention with an online softmax, fp32 arithmetic throughout,
// on the CUDA cores. bf16 inputs go to the tensor-core kernel of
// flash_attention_sm90.cu; the wrapper dispatches by dtype
// (kernels/flash_attention.py: kernel_for).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:64) together with the GQA head
// broadcast of its ops wrapper (src/repro/kernels/ops.py:140). It computes
// the Pallas kernel's function: s = (q . k) / sqrt(hd) in fp32, masked
// scores -1e30, running fp32 max, sum and accumulator, and
// out = acc / max(sum, 1e-30). p stays fp32 before the P.V product, as in
// the Pallas kernel (the JAX *model* path rounds p to v's dtype; see
// models/attention.py).
//
// Bound on an H100: operations. A causal (B, Hq, T, hd = 128) call does
// 4 * B * Hq * T^2 * hd / 2 flops on 2 * B * T * (Hq + Hkv) * hd elements:
// thousands of flops per byte, far above the card's ratio. In fp32 the
// tensor cores offer nothing exact, so the least time is the flops over
// the CUDA cores' 67 TFLOP/s. Only the fp32 checks and the depth-2 fp32
// comparison of the card with the CPU run this kernel; the main path's
// bf16 prefill runs the tensor-core kernel.
//
// Design: one CTA of 256 threads per (batch * q head, tile of 64 queries).
// The query tile, then each 64-key tile of K and V, is staged in shared
// memory. GQA is an index map: q head h
// reads kv head h / (Hq / Hkv); nothing is repeated in memory. Thread
// (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4): it computes
// the scores of key columns tx + 16 j (j < 4) with float4 loads along hd,
// and accumulates output columns of its rows in registers (hd / 16 a row:
// 64 fp32 registers a thread at hd 256, where the q, k, v and p tiles take
// 212 KB of shared memory, one CTA per SM). The 16 threads
// of a row are one half warp, so the row max and row sum are shuffles.
// Key tiles that lie wholly above the diagonal or before the window are
// never visited; inside a visited tile a masked entry contributes p = 0
// (never exp(0) of a row that has seen no key yet). Tails in Tq and Tk are
// masked, never padded: rows past Tq are not stored, keys past Tk are
// masked. A query row that sees no key at all returns 0 (the naive softmax
// would average every key); no caller's mask produces such a row.
#include "common.cuh"

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;
constexpr float FA_NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// Rows [t0, t0 + ROWS) of one head of a (B, T, H, HD) tensor (src points at
// row 0 of that head; rows are row_stride elements apart) into dst as fp32,
// LD floats per row. Rows at or past T_len are zero-filled.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int t0,
                                          int T_len) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += FA_THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + r < T_len) x = load4(src + (long long)(t0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int HD>
constexpr int fa_smem_bytes() {
  return ((FA_BQ + 2 * FA_BK) * (HD + 4) + FA_BQ * (FA_BK + 4)) *
         (int)sizeof(float);
}

// q: (B, Tq, Hq, HD); k, v: (B, Tk, Hkv, HD); o: (B, Tq, Hq, HD).
// grid (ceil(Tq / 64), B * Hq). window <= 0: no window.
template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Tq,
                     int Tk, int Hq, int Hkv, int causal, int window,
                     long long q_offset, float scale) {
  constexpr int LD = HD + 4;        // fp32 row stride of the q, k, v tiles
  constexpr int LP = FA_BK + 4;     // row stride of the p tile
  constexpr int CN = HD / 16;       // output columns per thread
  constexpr int VEC = CN >= 4 ? 4 : CN;
  constexpr int NV = CN / VEC;
  static_assert(HD % 16 == 0 && CN % VEC == 0,
                "hd must be 32, 64, 128 or 256");
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + FA_BQ * LD;
  float* vs = ks + FA_BK * LD;
  float* ps = vs + FA_BK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * FA_BQ;
  const long long q_rs = (long long)Hq * HD, kv_rs = (long long)Hkv * HD;
  const T* qb = q + ((long long)b * Tq * Hq + h) * HD;
  const T* kb = k + ((long long)b * Tk * Hkv + hk) * HD;
  const T* vb = v + ((long long)b * Tk * Hkv + hk) * HD;

  load_tile<T, HD, FA_BQ, LD>(qs, qb, q_rs, q0, Tq);

  // absolute positions of the tile's first and last query, and the keys
  // [k_lo, k_hi) that any of its rows can see
  const long long qa0 = q_offset + q0;
  const long long qa1 = q_offset + min(q0 + FA_BQ, Tq) - 1;
  long long k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min((long long)Tk, qa1 + 1);
  if (window > 0) k_lo = max(0LL, qa0 - window + 1);

  float m[4], l[4], acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
  }

  for (long long kt = (k_lo / FA_BK) * FA_BK; kt < k_hi; kt += FA_BK) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile<T, HD, FA_BK, LD>(ks, kb, kv_rs, (int)kt, Tk);
    load_tile<T, HD, FA_BK, LD>(vs, vb, kv_rs, (int)kt, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = qa0 + ty + 16 * i;
      bool valid[4];
      float rmax = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = kt + tx + 16 * j;
        valid[j] = kpos < Tk && (!causal || qpos >= kpos) &&
                   (window <= 0 || qpos - kpos < window);
        s[i][j] = valid[j] ? s[i][j] * scale : FA_NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // p complete

#pragma unroll 2
    for (int kk = 0; kk < FA_BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(ps + (ty + 16 * i) * LP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CN];
        const float* vrow = vs + (kk + u) * LD;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int col = n * 16 * VEC + tx * VEC;
          if constexpr (VEC == 4) {
            const float4 x = load4(vrow + col);
            vv[4 * n] = x.x; vv[4 * n + 1] = x.y;
            vv[4 * n + 2] = x.z; vv[4 * n + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vrow + col);
            vv[2 * n] = x.x; vv[2 * n + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(pv[i], u);
#pragma unroll
          for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)(b * (long long)Tq + row) * Hq + h) * HD;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store1(orow + n * 16 * VEC + tx * VEC + e, acc[i][n * VEC + e] / denom);
  }
}

template <typename T, int HD>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* o, int B, int Tq, int Tk, int Hq, int Hkv,
                          int causal, int window, long long q_offset,
                          cudaStream_t s) {
  constexpr int bytes = fa_smem_bytes<HD>();
  static_assert(bytes <= 227 * 1024, "the CTA's shared memory is 227 KB");
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, B * Hq);
  flash_fwd_kernel<T, HD><<<grid, FA_THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, Hq, Hkv, causal,
      window, q_offset, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_hd(int hd, const void* q, const void* k,
                               const void* v, void* o, int B, int Tq, int Tk,
                               int Hq, int Hkv, int causal, int window,
                               long long q_offset, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                           q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                           q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                            q_offset, s);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                            q_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q: (B, Tq, Hq, hd); k, v: (B, Tk, Hkv, hd); o: (B, Tq, Hq, hd); all fp32
// (bf16 runs flash_attention_sm90.cu's kernel), contiguous, 16-byte
// aligned. hd in {32, 64, 128, 256}; Hq a multiple of Hkv; window <= 0
// means no window. Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Tq,
                                      int Tk, int Hq, int Hkv, int hd,
                                      int causal, int window,
                                      long long q_offset, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (long long)B * Hq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_hd<float>(hd, q, k, v, o, B, Tq, Tk, Hq, Hkv, causal,
                            window, q_offset, s);
}
