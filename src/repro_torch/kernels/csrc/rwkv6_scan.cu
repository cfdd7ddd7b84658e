// RWKV6 chunked WKV recurrence with a state in and a state out, fp32.
//
// Replaces the TPU kernel rwkv6_scan_pallas
// (src/repro/kernels/rwkv6_scan.py:56) under the contract of the model's
// chunked_wkv (src/repro/models/rwkv6.py:61): the Pallas kernel's math plus
// an initial state and the final state, which decode carries from token to
// token (the Pallas kernel starts from zeros and drops the final state).
// Per head, with cum the running sum of the log decay within a chunk and
// total its last row:
//   out = (tril_{-1}((r e^{cum - lw}) (k e^{min(-cum, 60)})^T) + diag(r.u.k)) v
//         + (r e^{cum - lw}) S
//   S  <- S * e^{total} (on S's key axis, its first) + (k e^{total - cum})^T v
//
// Bound on an H100: at a (B = 4, H = 40, T = 4096, hd = 64) prefill the
// kernel reads 4 fp32 (B, T, H, hd) inputs and writes one (0.84 GB) for
// about 2.1e10 flops, so bytes and fp32 flops bound it about equally
// (about 0.3 ms each). At decode (T = 1) it moves the (hd, hd) fp32 state
// in and out per head and does almost no arithmetic: bytes, and in
// practice the launch.
//
// Design: one CTA of 256 threads per (batch, head), walking the chunks in
// order, the fp32 state held in shared memory from the first chunk to the
// last (hd x hd = 16 KB at hd = 64). Per chunk of c <= 64 steps the r, k,
// v and log-decay tiles are staged in shared memory; the diagonal bonus
// r.u.k is one warp per row; one thread per channel takes the cumulative
// decay (in the JAX package's association; the clamp of exp(-cum) at 60 is
// the model's); then thread (ty, tx) of a 16 x 16 grid computes 4 x 4
// entries of the c x c strictly-lower product with float4 loads along hd,
// the output rows ty + 16 i for columns tx + 16 j, and the state rows
// ty + 16 i. Entries above the diagonal or past c are never computed, so a
// decode step (c = 1) costs the state's load and store and little else.
// 160 CTAs at B = 4, H = 40 give 132 SMs one wave and a partial second.
#include "common.cuh"

constexpr int WKV_THREADS = 256;
constexpr int WKV_CHUNK_MAX = 64;
constexpr float WKV_EXP_CLAMP = 60.f;
constexpr int WKV_CUMSUM_BLOCK = 16;

template <int HD>
constexpr int wkv_smem_bytes() {
  // r, k, v, log decay, k e^{min(-cum,60)} tiles; the state; the c x c
  // product; the diagonal bonus; u
  return (5 * WKV_CHUNK_MAX * (HD + 4) + HD * (HD + 4) +
          WKV_CHUNK_MAX * (WKV_CHUNK_MAX + 4) + WKV_CHUNK_MAX + HD) *
         (int)sizeof(float);
}

// r, k, v, lw, out: (B, T, H, HD); u: (H, HD); state0, state_out:
// (B, H, HD, HD), the key axis first. grid B * H.
template <int HD>
__global__ void __launch_bounds__(WKV_THREADS)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ lw,
                      const float* __restrict__ u,
                      const float* __restrict__ state0,
                      float* __restrict__ out, float* __restrict__ state_out,
                      int T, int H, int chunk) {
  constexpr int LD = HD + 4;
  constexpr int LA = WKV_CHUNK_MAX + 4;
  constexpr int CN = HD / 16;        // hd columns (and state rows) a thread owns
  constexpr int PER_ROW = HD / 4;
  static_assert(HD % 32 == 0 && HD <= 64, "hd must be 32 or 64");
  extern __shared__ float sm[];
  float* R = sm;                          // r, then r e^{cum - lw}
  float* K = R + WKV_CHUNK_MAX * LD;      // k, then k e^{total - cum}
  float* V = K + WKV_CHUNK_MAX * LD;
  float* W = V + WKV_CHUNK_MAX * LD;      // log decay, then cum
  float* KD = W + WKV_CHUNK_MAX * LD;     // k e^{min(-cum, 60)}
  float* S = KD + WKV_CHUNK_MAX * LD;     // (HD x LD), key axis first
  float* A = S + HD * LD;                 // (64 x LA)
  float* diag = A + WKV_CHUNK_MAX * LA;
  float* us = diag + WKV_CHUNK_MAX;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long rs = (long long)H * HD;
  const long long base = ((long long)b * T * H + h) * HD;
  const long long sbase = ((long long)b * H + h) * HD * HD;

  for (int i = tid; i < HD * PER_ROW; i += WKV_THREADS) {
    const int row = i / PER_ROW, c = (i % PER_ROW) * 4;
    *reinterpret_cast<float4*>(S + row * LD + c) =
        *reinterpret_cast<const float4*>(state0 + sbase + row * HD + c);
  }
  if (tid < HD) us[tid] = u[h * HD + tid];

  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int c = min(chunk, T - t0);
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int i = tid; i < WKV_CHUNK_MAX * PER_ROW; i += WKV_THREADS) {
      const int row = i / PER_ROW, col = (i % PER_ROW) * 4;
      float4 x[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) x[a] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < c) {
        const long long g = base + (long long)(t0 + row) * rs + col;
        x[0] = *reinterpret_cast<const float4*>(r + g);
        x[1] = *reinterpret_cast<const float4*>(k + g);
        x[2] = *reinterpret_cast<const float4*>(v + g);
        x[3] = *reinterpret_cast<const float4*>(lw + g);
      }
      *reinterpret_cast<float4*>(R + row * LD + col) = x[0];
      *reinterpret_cast<float4*>(K + row * LD + col) = x[1];
      *reinterpret_cast<float4*>(V + row * LD + col) = x[2];
      *reinterpret_cast<float4*>(W + row * LD + col) = x[3];
    }
    __syncthreads();

    // diagonal bonus sum_d r u k, one warp per row, before r and k change
    for (int i = warp; i < c; i += WKV_THREADS / 32) {
      float acc = 0.f;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(R[i * LD + d] * us[d], K[i * LD + d], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) diag[i] = acc;
    }
    __syncthreads();

    // cumulative log decay, one thread per channel, associated as XLA's
    // CPU cumsum (and the plain version): sequential inside blocks of 16
    // steps, plus the sequential sum of the earlier blocks' totals. r
    // decays by the sum before its own step.
    if (tid < HD) {
      float pre = 0.f;
      for (int b0 = 0; b0 < c; b0 += WKV_CUMSUM_BLOCK) {
        float acc = 0.f;
        for (int t = b0; t < min(c, b0 + WKV_CUMSUM_BLOCK); ++t) {
          const float lwt = W[t * LD + tid];
          acc += lwt;
          const float cum = acc + pre;
          R[t * LD + tid] *= expf(cum - lwt);
          W[t * LD + tid] = cum;
        }
        pre += acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < c * HD; i += WKV_THREADS) {
      const int t = i / HD, d = i % HD;
      const float cum = W[t * LD + d], total = W[(c - 1) * LD + d];
      const float kv = K[t * LD + d];
      KD[t * LD + d] = kv * expf(fminf(-cum, WKV_EXP_CLAMP));
      K[t * LD + d] = kv * expf(total - cum);
    }
    __syncthreads();

    // A[i][j] = r_dec[i] . k_dec[j] for j < i, diag[i] at j = i, else 0;
    // a thread whose rows and columns hold no j < i < c computes nothing
    {
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
      const int imax = ty < c ? ty + 16 * ((c - 1 - ty) / 16) : -1;
      if (tx < imax) {
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
          float4 rv[4], kv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            rv[a] = *reinterpret_cast<const float4*>(R + (ty + 16 * a) * LD + d);
#pragma unroll
          for (int bb = 0; bb < 4; ++bb)
            kv[bb] = *reinterpret_cast<const float4*>(KD + (tx + 16 * bb) * LD + d);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) {
              float x = s[a][bb];
              x = fmaf(rv[a].x, kv[bb].x, x);
              x = fmaf(rv[a].y, kv[bb].y, x);
              x = fmaf(rv[a].z, kv[bb].z, x);
              x = fmaf(rv[a].w, kv[bb].w, x);
              s[a][bb] = x;
            }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int j = tx + 16 * bb;
          A[i * LA + j] = j < i ? s[a][bb] : (j == i ? diag[i] : 0.f);
        }
      }
    }
    __syncthreads();

    // out rows: sum_{j <= i} A[i][j] v[j] + r_dec[i] S
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      if (i >= c) break;
      float o[CN];
#pragma unroll
      for (int n = 0; n < CN; ++n) o[n] = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float aij = A[i * LA + j];
#pragma unroll
        for (int n = 0; n < CN; ++n)
          o[n] = fmaf(aij, V[j * LD + tx + 16 * n], o[n]);
      }
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float rd = R[i * LD + d];
#pragma unroll
        for (int n = 0; n < CN; ++n)
          o[n] = fmaf(rd, S[d * LD + tx + 16 * n], o[n]);
      }
      float* orow = out + base + (long long)(t0 + i) * rs;
#pragma unroll
      for (int n = 0; n < CN; ++n) orow[tx + 16 * n] = o[n];
    }
    __syncthreads();  // every read of S is done

    // S[d][e] <- S[d][e] e^{total[d]} + sum_j (k e^{total - cum})[j][d] v[j][e]
#pragma unroll
    for (int a = 0; a < CN; ++a) {
      const int d = ty + 16 * a;
      const float decay = expf(W[(c - 1) * LD + d]);
      float x[CN];
#pragma unroll
      for (int n = 0; n < CN; ++n) x[n] = 0.f;
      for (int j = 0; j < c; ++j) {
        const float kj = K[j * LD + d];
#pragma unroll
        for (int n = 0; n < CN; ++n)
          x[n] = fmaf(kj, V[j * LD + tx + 16 * n], x[n]);
      }
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        float* sp = S + d * LD + tx + 16 * n;
        *sp = *sp * decay + x[n];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * PER_ROW; i += WKV_THREADS) {
    const int row = i / PER_ROW, c = (i % PER_ROW) * 4;
    *reinterpret_cast<float4*>(state_out + sbase + row * HD + c) =
        *reinterpret_cast<const float4*>(S + row * LD + c);
  }
}

template <int HD>
static cudaError_t launch(const float* r, const float* k, const float* v,
                          const float* lw, const float* u, const float* s0,
                          float* out, float* s1, int B, int T, int H,
                          int chunk, cudaStream_t s) {
  constexpr int bytes = wkv_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  rwkv6_scan_kernel<HD><<<B * H, WKV_THREADS, bytes, s>>>(
      r, k, v, lw, u, s0, out, s1, T, H, chunk);
  return cudaGetLastError();
}

// r, k, v, logw, out: (B, T, H, hd) fp32; u: (H, hd) fp32; state0,
// state_out: (B, H, hd, hd) fp32; all contiguous and 16-byte aligned.
// hd in {32, 64}; 1 <= chunk <= 64 (the last chunk may be shorter).
// Returns a cudaError_t.
extern "C" int rwkv6_scan_launch(const float* r, const float* k,
                                 const float* v, const float* logw,
                                 const float* u, const float* state0,
                                 float* out, float* state_out, int B, int T,
                                 int H, int hd, int chunk, void* stream) {
  if (B < 1 || T < 1 || H < 1 || chunk < 1 || chunk > WKV_CHUNK_MAX ||
      (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(r, k, v, logw, u, state0, out, state_out, B, T, H,
                      chunk, s);
  if (hd == 32)
    return launch<32>(r, k, v, logw, u, state0, out, state_out, B, T, H,
                      chunk, s);
  return cudaErrorInvalidValue;
}
