// RWKV6 chunked WKV recurrence with a state in and a state out, fp32.
//
// Replaces the TPU kernel rwkv6_scan_pallas
// (src/repro/kernels/rwkv6_scan.py:56, kernel _rwkv6_kernel :22) under the
// contract of the model's chunked_wkv (src/repro/models/rwkv6.py:61): the
// Pallas kernel's math plus an initial state and the final state, which
// decode carries from token to token (the Pallas kernel starts from zeros
// and drops the final state). Per head, with cum the running sum of the
// log decay within a chunk and total its last row:
//   out = (tril_{-1}((r e^{cum - lw}) (k e^{min(-cum, 60)})^T) + diag(r.u.k)) v
//         + (r e^{cum - lw}) S
//   S  <- S * e^{total} (on S's key axis, its first) + (k e^{total - cum})^T v
//
// Bound on an H100: at a (B = 4, T = 4096, H = 40, hd = 64) prefill the
// kernel must read 4 fp32 (B, T, H, hd) inputs and write one (0.84 GB,
// 0.25 ms at 3.35 TB/s) for 1.7e10 counted flops (0.25 ms at 67 TFLOP/s
// fp32): bytes and operations bound it about equally. At decode (T = 1)
// it moves the (hd, hd) fp32 state of every head in and out: bytes. In
// practice the prefill is bound by the latency of each chunk's chain of
// steps (one CTA alone on an SM takes most of the kernel's time), so the
// design shortens that chain and keeps the SMs full.
//
// Prefill (rwkv6_chunk_kernel). The columns of S (the value axis) evolve
// independently: out[:, e] needs only S[:, e] and v[:, e]. So a (batch,
// head) is split over WKV_SPLIT = 2 CTAs, each owning hd / 2 value columns
// of S for the whole sequence and recomputing the chunk's decays and c x c
// matrix A. At B = 4, H = 40: 320 CTAs of 4 warps, 75.5 KB of shared
// memory and up to 168 registers a thread, 3 to an SM: one wave on 132 SMs
// (one CTA per (batch, head) left 28 SMs a second wave). Per chunk:
//  * r, k, the log decay and the CTA's v columns arrive by cp.async, each
//    tile issued as soon as the last chunk stops reading it (rows past a
//    short last chunk zero-filled); the next chunk's rows are prefetched
//    into L2;
//  * the running log decay takes 4 threads per channel, one per 16-step
//    block: sequential sums inside each block, then the earlier blocks'
//    totals added in sequence: XLA's CPU cumsum association, the plain
//    version's (ref.chunk_cumsum), bit for bit. Then r e^{cum - lw},
//    k e^{min(-cum, 60)} and k e^{total - cum} in place, as the plain
//    version forms them but with the SFU's exponential (fexp); a full
//    chunk runs this with no branch, so the compiler interleaves the
//    elements' latencies;
//  * the products r_dec S, A = r_dec k_dec^T, A v and (k e^{total -
//    cum})^T v run on the tensor cores (mma.sync m16n8k8 TF32) in fp32
//    precision: each operand split into TF32 hi + lo and three products
//    (lo.hi, hi.lo, hi.hi) summed into an fp32 accumulator, as the bf16
//    flash kernel splits p. Plain TF32 (10 mantissa bits) would miss the
//    1e-4 check; the split reaches ~2^-21 relative per product. The
//    fragments are scalar shared-memory loads free of bank conflicts
//    (row strides padded to 4 or 8 mod 32); each k-step splits all its
//    fragments, then issues the products pass by pass over the tiles, so
//    consecutive mma's are independent and no tile sits behind a branch
//    (warp w owns output n-tile w and A's n-tiles w and 7 - w, which
//    balances A's triangle; tiles above A's diagonal are computed and
//    written as 0). On the CUDA cores the same products were bound by
//    shared-memory wavefronts (1.3 FMA per wavefront at 2 x 4 register
//    tiles) and by register spills.
// Decode (rwkv6_decode_kernel, T = 1): no chunk machinery. One CTA per
// (batch, head); each thread owns 4 x 4 entries of S, reads them once,
// writes S e^{lw} + k v^T back and keeps r S's partial sums, which the CTA
// adds in a fixed order. The state may be updated in place (state_out ==
// state0): each entry is read and written by one thread.
#include "common.cuh"

constexpr int WKV_THREADS = 128;      // prefill CTA: 4 warps
constexpr int WKV_DEC_THREADS = 256;  // decode CTA
constexpr int WKV_CHUNK_MAX = 64;
constexpr int WKV_SPLIT = 2;          // CTAs per (batch, head), value axis
constexpr float WKV_EXP_CLAMP = 60.f;
constexpr int WKV_CUMSUM_BLOCK = 16;  // XLA's CPU cumsum block
constexpr int WKV_NBLK = WKV_CHUNK_MAX / WKV_CUMSUM_BLOCK;

template <int HD>
struct WkvShape {
  static constexpr int C = WKV_CHUNK_MAX;
  static constexpr int VS = HD / WKV_SPLIT;  // value columns per CTA
  // row strides (floats), padded so that every fragment load is free of
  // bank conflicts: rows read as (group, lane-in-group) want a stride of
  // 4 mod 32, rows read transposed want 8 mod 32
  static constexpr int LD = HD + 4;          // R
  static constexpr int LK = C + 4;           // K: k_dec, then the c x c A
  static constexpr int LW = HD + 8;          // W: k e^{total-cum}, read as KK^T
  static constexpr int LV = VS + 8;          // V and S, read as (k, n) operands
  static constexpr int SMEM_FLOATS = C * LD + C * LK + C * LW + C * LV +
                                     HD * LV + C + WKV_NBLK * HD + 2 * HD;
  static constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float a, float4 b, float* acc) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// x = hi + lo for the tensor cores, which read the 19 high bits of a TF32
// operand (10 explicit mantissa bits): hi is x rounded to them (to
// nearest, ties away: the add carries into the kept bits), lo = x - hi
// exactly, of which they keep 11 bits. hi + lo carries x to 2^-21 relative.
// Two integer operations and a subtraction; finite inputs only (cvt.rna
// adds an inf/NaN guard and costs twice as much)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// e^x for the decays: 2^(x log2 e) on the SFU (ex2.approx), two
// instructions where expf's accurate path takes eight. The rounding of
// x log2 e costs up to |x| 2^-24 ln 2 relative (2.5e-6 at the clamp's
// x = 60; the other exponents are <= 0, and results below 2^-126 flush to
// 0 where the plain version keeps a subnormal). The kernel's largest
// error against the plain version (an accurate exp) stays under a third
// of the check's 1e-4
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// cp.async a chunk's rows of a (B, T, H, hd) input into a tile of row
// stride LDT: 4 * N4 floats per row from src (the chunk's first row at the
// CTA's head and first column), rows past cn zero-filled. A thread's rows
// step by a constant, so its addresses are computed once.
template <int N4, int LDT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int cn, int tid) {
  constexpr int RP = WKV_THREADS / N4;  // rows per pass
  static_assert(WKV_THREADS % N4 == 0 && WKV_CHUNK_MAX % RP == 0, "");
  const int row0 = tid / N4, c4 = (tid % N4) * 4;
  const float* g = src + row0 * rs + c4;
  const long long step = RP * rs;
  float* d = dst + row0 * LDT + c4;
#pragma unroll
  for (int n = 0; n < WKV_CHUNK_MAX / RP; ++n) {
    const bool ok = row0 + n * RP < cn;
    cp_async16(d + n * RP * LDT, ok ? g : src, ok);
    g += step;
  }
}

// r, k, v, lw, out: (B, T, H, HD); u: (H, HD); state0, state_out:
// (B, H, HD, HD), the key axis first (they may alias). grid B * H *
// WKV_SPLIT: blockIdx.x = (b * H + h) * WKV_SPLIT + q, q the value slice.
template <int HD>
__global__ void __launch_bounds__(WKV_THREADS, 3)
    rwkv6_chunk_kernel(const float* __restrict__ r,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ lw,
                       const float* __restrict__ u, const float* state0,
                       float* __restrict__ out, float* state_out, int T,
                       int H, int chunk) {
  using S_ = WkvShape<HD>;
  constexpr int C = S_::C, VS = S_::VS;
  constexpr int LD = S_::LD, LK = S_::LK, LW = S_::LW, LV = S_::LV;
  constexpr int F4 = HD / 4, VF4 = VS / 4;
  constexpr int NW = WKV_THREADS / 32;     // 4 warps
  constexpr int NTN = VS / 8;              // n-tiles of the CTA's columns
  constexpr int KD8 = HD / 8;              // k-steps over the key axis
  static_assert(HD == 32 || HD == 64, "hd must be 32 or 64");
  static_assert(NW == 4 && NTN <= NW, "");

  extern __shared__ float sm[];
  float* R = sm;                      // r, then r e^{cum - lw}
  float* K = R + C * LD;              // k, then k e^{min(-cum,60)}, then A
  float* W = K + C * LK;              // log decay, then k e^{total - cum}
  float* V = W + C * LW;              // (C x LV), this CTA's v columns
  float* S = V + C * LV;              // (HD x LV), key axis first
  float* diag = S + HD * LV;          // r.u.k per step
  float* tot = diag + C;              // (WKV_NBLK x HD) block totals
  float* dec = tot + WKV_NBLK * HD;   // e^{total} per channel
  float* us = dec + HD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int q = blockIdx.x % WKV_SPLIT;
  const int bh = blockIdx.x / WKV_SPLIT;
  const int b = bh / H, h = bh % H;
  const long long rs = (long long)H * HD;         // stride of a time step
  const long long base = ((long long)b * T * H + h) * HD;
  const long long sbase = (long long)bh * HD * HD + q * VS;
  const int col0 = q * VS;
  // warps w < NTN own the CTA's n-tile w of the output and the state (all
  // their m-tiles); every warp owns A's n-tiles w and 7 - w (all four
  // m-tiles: 5 of A's 20 tiles on or below the diagonal, the rest 0)
  const bool owner = warp < NTN;
  const int ni = owner ? warp : 0;
  const int aj[2] = {warp, 7 - warp};

  for (int i = tid; i < HD * VF4; i += WKV_THREADS) {
    const int row = i / VF4, c4 = (i % VF4) * 4;
    *reinterpret_cast<float4*>(S + row * LV + c4) =
        ld4(state0 + sbase + (long long)row * HD + c4);
  }
  if (tid < HD) us[tid] = u[h * HD + tid];

  // the chunk starting at step tc of this CTA's four tiles
  auto load_r = [&](int tc, int cn) {
    load_rows<F4, LD>(R, r + base + tc * rs, rs, cn, tid);
  };
  auto load_lw = [&](int tc, int cn) {
    load_rows<F4, LW>(W, lw + base + tc * rs, rs, cn, tid);
  };
  auto load_kv = [&](int tc, int cn) {
    load_rows<F4, LK>(K, k + base + tc * rs, rs, cn, tid);
    load_rows<VF4, LV>(V, v + base + tc * rs + col0, rs, cn, tid);
  };
  // the first chunk's tiles; a later chunk's are issued as soon as the
  // tiles are free in the chunk before it (see below)
  load_r(0, min(chunk, T));
  load_lw(0, min(chunk, T));
  load_kv(0, min(chunk, T));
  // the next chunk's rows of r, k, log decay and v are prefetched into L2
  // while this one is computed: this thread takes 128-byte line pf_line
  // of rows pf_row + (WKV_THREADS / LINES) n
  constexpr int LINES = HD * 4 / 128;
  const int pf_row = tid / LINES, pf_line = tid % LINES;
  const float* const pf_src[4] = {r, k, lw, v};

  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int c = min(chunk, T - t0);
    const int tn = t0 + chunk, cn = min(chunk, T - tn);  // the next chunk
    const int ks = (c + 7) / 8;  // k-steps over the chunk's rows
    if (tn < T) {
      for (int row = pf_row; row < cn; row += WKV_THREADS / LINES)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          prefetch_l2(pf_src[x] + base + (long long)(tn + row) * rs +
                      pf_line * 32);
    }
    cp_async_wait_all();
    __syncthreads();

    // the diagonal bonus r.u.k, rows warp + 4 m, before r and k change;
    // the rows' shuffle trees interleaved
    {
      constexpr int RPW = C / NW;
      float acc[RPW];
#pragma unroll
      for (int m = 0; m < RPW; ++m) {
        const int i = warp + NW * m;
        acc[m] = 0.f;
#pragma unroll
        for (int d = lane; d < HD; d += 32)
          acc[m] = fmaf(R[i * LD + d] * us[d], K[i * LK + d], acc[m]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int m = 0; m < RPW; ++m)
          acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
      if (lane == 0)
#pragma unroll
        for (int m = 0; m < RPW; ++m) diag[warp + NW * m] = acc[m];
    }
    // running log decay: 4 HD roles (channel cd, 16-step block cs), two
    // per thread at hd 64. Pass 1: sums inside the role's block
    constexpr int ROLES = 4 * HD / WKV_THREADS;
    float run[ROLES][WKV_CUMSUM_BLOCK];
#pragma unroll
    for (int m = 0; m < ROLES; ++m) {
      const int role = tid + WKV_THREADS * m;
      const int cd = role % HD, cs = role / HD, tb = cs * WKV_CUMSUM_BLOCK;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < WKV_CUMSUM_BLOCK; ++j) {
        // rows past c are zero-filled: adding them leaves the sums as they are
        acc += W[(tb + j) * LW + cd];
        run[m][j] = acc;
      }
      tot[cs * HD + cd] = acc;
    }
    __syncthreads();

    // pass 2: the earlier blocks' totals in sequence, then the decays, as
    // the plain version forms them (three exponentials per element, by
    // fexp). The elements are independent: a full chunk takes them with no
    // branch, so the compiler interleaves their latencies
    {
      const int last = (c - 1) / WKV_CUMSUM_BLOCK;
      float pre[ROLES], total[ROLES];
#pragma unroll
      for (int m = 0; m < ROLES; ++m) {
        const int role = tid + WKV_THREADS * m;
        const int cd = role % HD, cs = role / HD;
        float pl = 0.f;
        pre[m] = 0.f;
        for (int j = 0; j < last; ++j) {
          const float tj = tot[j * HD + cd];
          pl = j == 0 ? tj : pl + tj;
          if (j + 1 == cs) pre[m] = pl;
        }
        total[m] = last == 0 ? tot[cd] : tot[last * HD + cd] + pl;
        if (cs == 0) dec[cd] = expf(total[m]);
      }
      auto decay = [&](int m, int j) {
        const int role = tid + WKV_THREADS * m;
        const int cd = role % HD, cs = role / HD;
        const int t = cs * WKV_CUMSUM_BLOCK + j;
        const float cum = cs == 0 ? run[m][j] : run[m][j] + pre[m];
        const float lwt = W[t * LW + cd], kv = K[t * LK + cd];
        R[t * LD + cd] *= fexp(cum - lwt);
        K[t * LK + cd] = kv * fexp(fminf(-cum, WKV_EXP_CLAMP));
        W[t * LW + cd] = kv * fexp(total[m] - cum);
      };
      if (c == C) {
#pragma unroll
        for (int j = 0; j < WKV_CUMSUM_BLOCK; ++j)
#pragma unroll
          for (int m = 0; m < ROLES; ++m) decay(m, j);
      } else {
#pragma unroll
        for (int j = 0; j < WKV_CUMSUM_BLOCK; ++j)
#pragma unroll
          for (int m = 0; m < ROLES; ++m)
            if ((tid + WKV_THREADS * m) / HD * WKV_CUMSUM_BLOCK + j < c)
              decay(m, j);
      }
    }
    __syncthreads();

    // one pass over the key axis: r_dec S on the warp's output tiles
    // (four m-tiles, n-tile ni) and A = r_dec k_dec^T on its tiles of A
    // (n-tiles aj[], four m-tiles each); r_dec's fragments are split once
    // per k-step and shared. Each k-step splits every fragment first, then
    // issues the products pass by pass (lo.hi, hi.lo, hi.hi) over the
    // tiles: consecutive mma's are independent (a warp issues in order),
    // and no tile is behind a branch
    float o1[4][4] = {};
    float a1[2][4][4] = {};
    for (int kk = 0; kk < KD8; ++kk) {
      unsigned rh[4][4], rl[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const float* a = R + 16 * mi * LD + 8 * kk;
        split_tf32(a[gid * LD + tig], rh[mi][0], rl[mi][0]);
        split_tf32(a[(gid + 8) * LD + tig], rh[mi][1], rl[mi][1]);
        split_tf32(a[gid * LD + tig + 4], rh[mi][2], rl[mi][2]);
        split_tf32(a[(gid + 8) * LD + tig + 4], rh[mi][3], rl[mi][3]);
      }
      unsigned bh[3][2], bl[3][2];  // S's n-tile, then A's two n-tiles
      {
        const float* bb = S + 8 * kk * LV + 8 * ni;
        split_tf32(bb[tig * LV + gid], bh[0][0], bl[0][0]);
        split_tf32(bb[(tig + 4) * LV + gid], bh[0][1], bl[0][1]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* bb = K + 8 * aj[p] * LK + 8 * kk;
        split_tf32(bb[gid * LK + tig], bh[p + 1][0], bl[p + 1][0]);
        split_tf32(bb[gid * LK + tig + 4], bh[p + 1][1], bl[p + 1][1]);
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const unsigned* ar = pass == 0 ? rl[mi] : rh[mi];
          mma_tf32(o1[mi], ar, pass == 1 ? bl[0] : bh[0]);
          mma_tf32(a1[0][mi], ar, pass == 1 ? bl[1] : bh[1]);
          mma_tf32(a1[1][mi], ar, pass == 1 ? bl[2] : bh[2]);
        }
      }
    }
    __syncthreads();  // every read of k_dec, r_dec and the old S is done
    if (tn < T) load_r(tn, cn);  // r_dec is free

    // A into K's tile: the products below the diagonal, r.u.k on it, 0
    // above it
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = 16 * mi + gid + 8 * (x >> 1);
          const int j = 8 * aj[p] + 2 * tig + (x & 1);
          K[i * LK + j] = j < i ? a1[p][mi][x] : (j == i ? diag[i] : 0.f);
        }
    __syncthreads();  // A is in place

    // one pass over the chunk's rows j: A v on the output tiles (A is 0
    // above the diagonal) and the state's (k e^{total - cum})^T v on the
    // state tiles; v's fragment is split once per k-step and shared
    float o2[4][4] = {};
    float ds[HD / 16][4] = {};
    if (owner) {
      for (int kk = 0; kk < ks; ++kk) {
        const float* bb = V + 8 * kk * LV + 8 * ni;
        unsigned bh[2], bl[2];
        split_tf32(bb[tig * LV + gid], bh[0], bl[0]);
        split_tf32(bb[(tig + 4) * LV + gid], bh[1], bl[1]);
        // A's rows (0 above the diagonal)
        unsigned ah[4][4], al[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const float* a = K + 16 * mi * LK + 8 * kk;
          split_tf32(a[gid * LK + tig], ah[mi][0], al[mi][0]);
          split_tf32(a[(gid + 8) * LK + tig], ah[mi][1], al[mi][1]);
          split_tf32(a[gid * LK + tig + 4], ah[mi][2], al[mi][2]);
          split_tf32(a[(gid + 8) * LK + tig + 4], ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            mma_tf32(o2[mi], pass == 0 ? al[mi] : ah[mi],
                     pass == 1 ? bl : bh);
        // KK^T's rows: A(d, j) = KK[j][d], read transposed
#pragma unroll
        for (int m = 0; m < HD / 16; ++m) {
          const float* a = W + 8 * kk * LW + 16 * m;
          split_tf32(a[tig * LW + gid], ah[m][0], al[m][0]);
          split_tf32(a[tig * LW + gid + 8], ah[m][1], al[m][1]);
          split_tf32(a[(tig + 4) * LW + gid], ah[m][2], al[m][2]);
          split_tf32(a[(tig + 4) * LW + gid + 8], ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int m = 0; m < HD / 16; ++m)
            mma_tf32(ds[m], pass == 0 ? al[m] : ah[m], pass == 1 ? bl : bh);
      }
      // S[d][e] <- S[d][e] e^{total[d]} + (KK^T v)[d][e] on the n-tile
#pragma unroll
      for (int m = 0; m < HD / 16; ++m)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int d = 16 * m + gid + 8 * (x >> 1);
          float* sp = S + d * LV + 8 * ni + 2 * tig + (x & 1);
          *sp = *sp * dec[d] + ds[m][x];
        }
    }
    if (tn < T) {
      __syncthreads();  // every read of A, KK and v is done
      load_lw(tn, cn);
      load_kv(tn, cn);
    }
    // out = A v + r_dec S
    if (owner) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * mi + gid + 8 * hf;
          if (i < c) {
            float2 res;
            res.x = o2[mi][2 * hf] + o1[mi][2 * hf];
            res.y = o2[mi][2 * hf + 1] + o1[mi][2 * hf + 1];
            *reinterpret_cast<float2*>(out + base + (long long)(t0 + i) * rs +
                                       col0 + 8 * ni + 2 * tig) = res;
          }
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * VF4; i += WKV_THREADS) {
    const int row = i / VF4, c4 = (i % VF4) * 4;
    *reinterpret_cast<float4*>(state_out + sbase + (long long)row * HD + c4) =
        ld4(S + row * LV + c4);
  }
}

// T = 1: out[e] = (sum_d r u k) v[e] + sum_d r[d] S[d][e];
// S[d][e] <- S[d][e] e^{lw[d]} + k[d] v[e]. grid B * H, thread (g, e4) owns
// rows [RPT g, RPT g + RPT) and columns [4 e4, 4 e4 + 4) of S.
template <int HD>
__global__ void __launch_bounds__(WKV_DEC_THREADS)
    rwkv6_decode_kernel(const float* __restrict__ r,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ lw,
                        const float* __restrict__ u, const float* state0,
                        float* __restrict__ out, float* state_out, int H) {
  constexpr int F4 = HD / 4;               // float4 columns
  constexpr int G = WKV_DEC_THREADS / F4;  // row groups
  constexpr int RPT = HD / G;              // rows per thread
  static_assert(RPT * G == HD && RPT >= 1, "");
  __shared__ float part[G][HD];
  __shared__ float diag_s;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, h = bh % H;
  const long long vb = (long long)bh * HD;   // (B, 1, H, HD) row of (b, h)
  const long long sb = (long long)bh * HD * HD;
  const int e4 = tid % F4, g = tid / F4;

  if (tid < 32) {
    float acc = 0.f;
    for (int d = tid; d < HD; d += 32)
      acc = fmaf(r[vb + d] * u[h * HD + d], k[vb + d], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (tid == 0) diag_s = acc;
  }
  const float4 vv = ld4(v + vb + 4 * e4);
  float4 s[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    s[m] = ld4(state0 + sb + (long long)(RPT * g + m) * HD + 4 * e4);
  float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int d = RPT * g + m;
    const float rd = r[vb + d], kd = k[vb + d], wd = expf(lw[vb + d]);
    fma4(rd, s[m], o);
    float4 ns;
    ns.x = s[m].x * wd + kd * vv.x;
    ns.y = s[m].y * wd + kd * vv.y;
    ns.z = s[m].z * wd + kd * vv.z;
    ns.w = s[m].w * wd + kd * vv.w;
    *reinterpret_cast<float4*>(state_out + sb + (long long)d * HD + 4 * e4) =
        ns;
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) part[g][4 * e4 + n] = o[n];
  __syncthreads();
  if (tid < HD) {
    float acc = 0.f;
    for (int j = 0; j < G; ++j) acc += part[j][tid];
    out[vb + tid] = diag_s * v[vb + tid] + acc;
  }
}

template <int HD>
static cudaError_t launch(const float* r, const float* k, const float* v,
                          const float* lw, const float* u, const float* s0,
                          float* out, float* s1, int B, int T, int H,
                          int chunk, cudaStream_t s) {
  if (T == 1) {
    rwkv6_decode_kernel<HD><<<B * H, WKV_DEC_THREADS, 0, s>>>(
        r, k, v, lw, u, s0, out, s1, H);
    return cudaGetLastError();
  }
  constexpr int bytes = WkvShape<HD>::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  // 3 CTAs of 72.4 KB to an SM: ask for the largest shared-memory carveout
  e = cudaFuncSetAttribute(rwkv6_chunk_kernel<HD>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  rwkv6_chunk_kernel<HD><<<B * H * WKV_SPLIT, WKV_THREADS, bytes, s>>>(
      r, k, v, lw, u, s0, out, s1, T, H, chunk);
  return cudaGetLastError();
}

// r, k, v, logw, out: (B, T, H, hd) fp32; u: (H, hd) fp32; state0,
// state_out: (B, H, hd, hd) fp32, which may be the same buffer (the state
// is then updated in place); all contiguous and 16-byte aligned. hd in
// {32, 64}; 1 <= chunk <= 64 (the last chunk may be shorter). Returns a
// cudaError_t.
extern "C" int rwkv6_scan_launch(const float* r, const float* k,
                                 const float* v, const float* logw,
                                 const float* u, const float* state0,
                                 float* out, float* state_out, int B, int T,
                                 int H, int hd, int chunk, void* stream) {
  if (B < 1 || T < 1 || H < 1 || chunk < 1 || chunk > WKV_CHUNK_MAX ||
      (long long)B * H * WKV_SPLIT > 0x7fffffffLL)
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
