// Flash attention forward for bf16 on Hopper's tensor cores: causal (+
// optional sliding window) GQA attention with an online softmax.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:64) together with the GQA head
// broadcast of its ops wrapper (src/repro/kernels/ops.py:140), for bf16
// q, k, v; the wrapper sends fp32 inputs to the CUDA-core kernel of
// flash_attention.cu. It computes the Pallas kernel's function:
// s = (q . k) / sqrt(hd) with fp32 accumulation, masked scores -1e30 (a
// masked entry contributes p = 0), fp32 running max, sum and accumulator,
// out = acc / max(sum, 1e-30) rounded to bf16. p stays fp32-precise through
// P.V, as in the Pallas kernel: the tensor cores take bf16 operands, so p
// is split into hi = bf16(p) and lo = bf16(p - hi), and both products go
// into the one fp32 accumulator. hi + lo carries 16 of p's 24 significant
// bits; p rounded to bf16 alone misses the one-bf16-ulp check against the
// fp32 plain version in about a tenth of the outputs (PERF.md). The
// exponentials run in the log2 domain (ex2.approx, scores scaled by
// log2(e) / sqrt(hd) in one fma), a relative error near 2^-22 per p.
//
// Bound on an H100: operations. The main path's call (B = 4, T = 4096,
// Hq 16, Hkv 8, hd 128, causal) counts 4 * hd * T (T + 1) / 2 * B * Hq =
// 2.75e11 flops on 0.1 GB of q, k, v and out: 0.278 ms at 989 TFLOP/s
// bf16 dense. With the hi/lo split the kernel issues 1.5x the counted
// flops (Q.K^T once, P.V twice).
//
// Design, against that bound: every product runs on the tensor cores as
// wgmma (bf16 x bf16 -> fp32), with its shared-memory operands brought in
// by TMA, so no thread spends registers or instructions on copies, and
// each warpgroup keeps the tensor cores fed while it runs its softmax.
// - A CTA owns one (batch x q head, 128-query tile): two consumer
//   warpgroups of 64 query rows each and one producer warpgroup, of which
//   one thread issues the TMA loads; setmaxnreg moves registers from the
//   producer (24) to the consumers (240).
// - K and V tiles of 64 keys sit in a 4-stage ring with full/empty
//   mbarriers, so loads run up to three tiles ahead of the products (2
//   stages at hd 256, one tile ahead: shared memory holds no more).
// - The tensor maps are 4-D over the contiguous (B, T, H, hd) tensors
//   (dims hd, H, T, B; box COLS x 1 x rows x 1): a tail tile is zero-filled
//   by the hardware and never reads the next batch's rows, and GQA is the
//   kv-head coordinate h / (Hq / Hkv), so nothing is repeated in memory.
//   The 128-byte swizzle (64-byte at hd 32) matches the wgmma descriptors;
//   a row of hd 128 is two 64-column boxes, of hd 256 four.
// - S = Q K^T is wgmma m64n64k16 with both operands in shared memory,
//   K-major. The online softmax runs on the accumulator fragments, where a
//   row is spread over 4 threads (two shuffles). The mask is evaluated
//   only on tiles that cross the diagonal, the window's edge or Tk (a
//   separate instantiation of the softmax, so the others run no test per
//   element); tiles wholly above the diagonal or before the window are
//   never loaded.
// - O += P V: P's hi and lo halves are built in registers in the layout of
//   wgmma's A operand, which for 16-bit types is S's accumulator layout,
//   two fp32 to one bf16x2 register. V is B from shared memory, MN-major
//   (the transpose bit); two wgmma m64n{hd}k16 per 16 keys (at hd 256,
//   four m64n128k16: each half of V's columns into its half of O).
// - Within a warpgroup the products of two tiles overlap the softmax:
//   S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued together, and the
//   softmax of S_i runs while the P.V product is still on the tensor
//   cores. The loop is peeled (S_0 alone first, the last P.V alone after)
//   so that every group in flight is known to the compiler, which
//   otherwise serialises the products. Key tiles of 64 keep S, O and both
//   P halves in registers without spills (at 128 keys ptxas spills, and
//   the overlapped kernel ran slower on the card than without overlap).
// - The grid runs the heaviest q tiles first (causal: the last tiles see
//   the most keys), so the last wave is made of light tiles.
// Rows past Tq are not stored; keys past Tk are masked, never padded. A
// query row that sees no key returns 0.
// cuda.h for CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;        // query rows per CTA
constexpr int BK = 64;         // keys per tile
constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 query rows each
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Tile {
  static constexpr int SW = HD >= 64 ? 128 : 64;  // swizzle span, bytes
  static constexpr int COLS = SW / 2;             // bf16 columns of one box
  static constexpr int NCHUNK = HD / COLS;        // boxes per row of hd
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;    // one of K, V
  // K/V ring depth: 4 stages up to hd 128; at hd 256 the 64 KB Q tile and
  // 4 stages of 2 x 32 KB would need 320 KB of the CTA's 227 KB, so 2
  // (192 KB)
  static constexpr int STAGES = HD > 128 ? 2 : 4;
  // P.V as products of at most 128 output columns (wgmma's accumulator
  // for n256 would be one 128-register fragment; two n128 halves keep the
  // same registers in the same layout)
  static constexpr int PV_N = HD > 128 ? 128 : HD;
  // wgmma descriptor layout code: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  // Q, then K and V per stage; 1 KB to align the base to the swizzle
  // atom; the barriers
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024 + 64;
  static_assert(SMEM <= 227 * 1024, "the CTA's shared memory is 227 KB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts seconds traps, so a lost arrival is a launch error, not a hung
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout code
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous products (they are written until the wait).
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64 x 64, fp32) += A(64 x 16, smem) * B(16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, 1, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// D(64 x 128, fp32) += A(64 x 16, registers) * B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D(64 x 64, fp32) += A(64 x 16, registers) * B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D(64 x 32, fp32) += A(64 x 16, registers) * B(16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}


// issue S = Q K^T for this warpgroup's 64 rows and one K tile (the caller
// fences and commits)
template <int HD>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t sq, uint32_t kd,
                                         int wg) {
  using C = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 / C::COLS;
    const uint32_t off = (kk * 16 % C::COLS) * 2;
    wgmma_ss_n64(
        sc,
        smem_desc(sq + c * BQ * C::SW + wg * 64 * C::SW + off, 16, 8 * C::SW,
                  C::LAYOUT),
        smem_desc(kd + c * BK * C::SW + off, 16, 8 * C::SW, C::LAYOUT));
  }
}

// issue O += P_hi V + P_lo V over one V tile (the caller fences and
// commits)
template <int HD>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* ph,
                                         const uint32_t* pl, uint32_t vd) {
  using C = Tile<HD>;
  // the V columns of one product span PV_N / COLS boxes of BK rows
  constexpr int HALF_BYTES = C::PV_N / C::COLS * BK * C::SW;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < HD / C::PV_N; ++n) {
      const uint64_t dv = smem_desc(vd + n * HALF_BYTES + kk * 16 * C::SW,
                                    BK * C::SW, 8 * C::SW, C::LAYOUT);
      wgmma_rs<C::PV_N>(acc + n * C::PV_N / 2, ph + 4 * kk, dv);
      wgmma_rs<C::PV_N>(acc + n * C::PV_N / 2, pl + 4 * kk, dv);
    }
  }
}

// The online softmax of one S tile, in place: sc[4 j + e] is row r (e < 2)
// or r + 8 (e >= 2), key kt + 8 j + cq + (e & 1). Masks the tile if
// MASKED (a separate instantiation, so that the tiles inside the mask run
// no per-element test), updates the running maxima m (log2 domain), and
// leaves p in sc, the corrections exp2(m_old - m_new) in cr and the
// tile's partial row sums in rs.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float* sc, long long kt,
                                             long long qp0, int cq, int Tk,
                                             int causal, int window,
                                             float scale_log2, float& m0,
                                             float& m1, float& cr0, float& cr1,
                                             float& rs0, float& rs1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      if (MASKED) {
        const long long kp = kt + 8 * j + cq + (e & 1);
        const long long qp = e < 2 ? qp0 : qp0 + 8;
        const bool ok = kp < Tk && (!causal || qp >= kp) &&
                        (window <= 0 || qp - kp < window);
        x = ok ? x : NEG_INF;
        sc[4 * j + e] = x;
      }
      if (e < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // scale > 0, so the largest scaled score is the scaled largest score
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  cr0 = ex2(m0 - mn0);
  cr1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  rs0 = 0.f;
  rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * j + e];
      const float mn = e < 2 ? mn0 : mn1;
      const float p =
          MASKED && x <= NEG_INF ? 0.f : ex2(fmaf(x, scale_log2, -mn));
      sc[4 * j + e] = p;
      if (e < 2) rs0 += p;
      else rs1 += p;
    }
}

// p (fp32, in S's accumulator layout) to its hi and lo bf16 halves as
// wgmma A fragments: for 16 keys kk, registers 4 kk .. 4 kk + 3 hold (r,
// keys cq..), (r + 8, cq..), (r, 8 + cq..), (r + 8, 8 + cq..); so fragment
// group j's pairs go to 2 j (row r) and 2 j + 1 (row r + 8)
__device__ __forceinline__ void split_p(const float* sc, uint32_t* ph,
                                        uint32_t* pl) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float p0 = sc[4 * j + 2 * half], p1 = sc[4 * j + 2 * half + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      ph[2 * j + half] = as_u32(hi);
      pl[2 * j + half] = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
}

// q: (B, Tq, Hq, HD) through tmq; k, v: (B, Tk, Hkv, HD) through tmk, tmv;
// o: (B, Tq, Hq, HD). grid (B * Hq, ceil(Tq / BQ)); window <= 0: none;
// scale_log2 = log2(e) / sqrt(HD).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      __nv_bfloat16* __restrict__ o, int Tq, int Tk, int Hq,
                      int Hkv, int causal, int window, long long q_offset,
                      float scale_log2) {
  using C = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + C::Q_BYTES;  // stage s: K, then V
  const uint32_t bars = skv + C::STAGES * 2 * C::KV_BYTES;
  // full[s] at bars + 8 s, empty[s] after them, then Q's barrier
  const uint32_t qbar = bars + 8u * 2 * C::STAGES;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tile first
  // absolute positions of the tile's first and last query, and the keys
  // [k_lo, k_hi) that any of its rows can see
  const long long qa0 = q_offset + q0;
  const long long qa1 = q_offset + min(q0 + BQ, Tq) - 1;
  long long k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min((long long)Tk, qa1 + 1);
  if (window > 0) k_lo = max(0LL, qa0 - window + 1);
  const long long kt0 = (k_lo / BK) * BK;
  const int n_tiles = k_hi > kt0 ? (int)((k_hi - kt0 + BK - 1) / BK) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bars + 8u * s, 1);
      mbar_init(bars + 8u * (C::STAGES + s), CONSUMERS * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::NCHUNK; ++c)
        tma_load_4d(sq + c * BQ * C::SW, &tmq, qbar, c * C::COLS, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        // the stage's previous tile (i - C::STAGES) has been consumed
        if (i >= C::STAGES)
          mbar_wait(bars + 8u * (C::STAGES + s), (i / C::STAGES - 1) & 1);
        const uint32_t kd = skv + s * 2 * C::KV_BYTES, vd = kd + C::KV_BYTES;
        const uint32_t full = bars + 8u * s;
        const int kt = (int)(kt0 + (long long)i * BK);
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int c = 0; c < C::NCHUNK; ++c) {
          tma_load_4d(kd + c * BK * C::SW, &tmk, full, c * C::COLS, hk, kt, b);
          tma_load_4d(vd + c * BK * C::SW, &tmv, full, c * C::COLS, hk, kt, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    constexpr int NO = HD / 2;  // O fragment: fp32 per thread
    constexpr int NS = BK / 2;  // S fragment: fp32 per thread
    const int t = threadIdx.x % 128, lane = t % 32;
    // the thread's two rows (r, r + 8) of the tile, and its first column
    // within each 8-column group of a fragment
    const int r = wg * 64 + (t / 32) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const long long qp0 = qa0 + r;
    // this warpgroup's first and last query position: a tile needs the
    // mask if it crosses Tk, the diagonal or the window's edge for them
    const long long wq0 = qa0 + wg * 64, wq1 = wq0 + 63;
    auto masked = [&](long long kt) {
      return kt + BK > Tk || (causal && kt + BK - 1 > wq0) ||
             (window > 0 && wq1 - kt >= window);
    };

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float sc[NS];
    uint32_t ph[BK / 4], pl[BK / 4];
    mbar_wait(qbar, 0);
    __syncwarp();
    if (n_tiles > 0) {
      {  // S_0 alone
        mbar_wait(bars, 0);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] = 0.f;
        pin<NS>(sc);
        wgmma_fence();
        issue_qk<HD>(sc, sq, skv, wg);
        wgmma_commit();
        wgmma_wait<0>();
        pin<NS>(sc);
        // the masked form is right for any tile; the first runs once
        float cr0, cr1;
        softmax_tile<true>(sc, kt0, qp0, cq, Tk, causal, window, scale_log2,
                           m0, m1, cr0, cr1, l0, l1);
        split_p(sc, ph, pl);
      }
      for (int i = 1; i < n_tiles; ++i) {
        // S_i = Q K_i^T and O += P_{i-1} V_{i-1}, then S_i's softmax while
        // the P.V product runs
        const int s = i % C::STAGES, sp = (i + C::STAGES - 1) % C::STAGES;
        const long long kt = kt0 + (long long)i * BK;
        mbar_wait(bars + 8u * s, (i / C::STAGES) & 1);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[j] = 0.f;
        pin<NS>(sc);
        pin<NO>(acc);
        pin<BK / 4>(ph);
        pin<BK / 4>(pl);
        wgmma_fence();
        issue_qk<HD>(sc, sq, skv + s * 2 * C::KV_BYTES, wg);
        wgmma_commit();
        issue_pv<HD>(acc, ph, pl, skv + sp * 2 * C::KV_BYTES + C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();
        pin<NS>(sc);
        float cr0, cr1, rs0, rs1;
        if (masked(kt))
          softmax_tile<true>(sc, kt, qp0, cq, Tk, causal, window, scale_log2,
                             m0, m1, cr0, cr1, rs0, rs1);
        else
          softmax_tile<false>(sc, kt, qp0, cq, Tk, causal, window,
                              scale_log2, m0, m1, cr0, cr1, rs0, rs1);
        wgmma_wait<0>();
        pin<NO>(acc);
        pin<BK / 4>(ph);
        pin<BK / 4>(pl);
        mbar_arrive(bars + 8u * (C::STAGES + sp));  // stage sp is free
        l0 = l0 * cr0 + rs0;
        l1 = l1 * cr1 + rs1;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j] *= cr0;
          acc[4 * j + 1] *= cr0;
          acc[4 * j + 2] *= cr1;
          acc[4 * j + 3] *= cr1;
        }
        split_p(sc, ph, pl);
      }
      {  // the last P.V alone
        const int sp = (n_tiles - 1) % C::STAGES;
        pin<NO>(acc);
        pin<BK / 4>(ph);
        pin<BK / 4>(pl);
        wgmma_fence();
        issue_pv<HD>(acc, ph, pl, skv + sp * 2 * C::KV_BYTES + C::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        pin<NO>(acc);
        pin<BK / 4>(ph);
        pin<BK / 4>(pl);
        mbar_arrive(bars + 8u * (C::STAGES + sp));
      }
    }

    // out = acc / max(l, 1e-30); the row sum is spread over 4 threads
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r + 8 * half;
      if (row >= Tq) continue;
      const float d = half ? d1 : d0;
      __nv_bfloat16* orow = o + (((long long)b * Tq + row) * Hq + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] / d,
                                  acc[4 * j + 2 * half + 1] / d);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, T, H, hd) bf16 tensor: dims (hd, H, T,
// B), box (cols, 1, rows, 1); out-of-range rows read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int H, int T,
                int B, int cols, int rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)T * H * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Tq, int Tk, int Hq, int Hkv, int causal,
                   int window, long long q_offset, cudaStream_t s) {
  using C = Tile<HD>;
  const CUtensorMapSwizzle sw =
      C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, HD, Hq, Tq, B, C::COLS, BQ, sw) ||
      !tensor_map(&mk, k, HD, Hkv, Tk, B, C::COLS, BK, sw) ||
      !tensor_map(&mv, v, HD, Hkv, Tk, B, C::COLS, BK, sw))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)HD));
  flash_sm90_kernel<HD><<<grid, THREADS, C::SMEM, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Tq, Tk, Hq, Hkv, causal,
      window, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Tq, Hq, hd); k, v: (B, Tk, Hkv, hd); o: (B, Tq, Hq, hd); all bf16,
// contiguous, 16-byte aligned. hd in {32, 64, 128, 256}; Hq a multiple of
// Hkv;
// window <= 0 means no window. Returns a cudaError_t.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Tq, int Tk, int Hq, int Hkv,
                                           int hd, int causal, int window,
                                           long long q_offset, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (long long)B * Hq > 0x7fffffffLL || (Tq + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                        q_offset, s);
    case 64:
      return launch<64>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                        q_offset, s);
    case 128:
      return launch<128>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                         q_offset, s);
    case 256:
      return launch<256>(q, k, v, o, B, Tq, Tk, Hq, Hkv, causal, window,
                         q_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}
