// Fused sparse-LBG decision: per (client, block row) of a gradient leaf, in
// one kernel, the client's ||g||^2, g gathered at the LBG's block-local
// indices, and the row's top-kb entries by |g| (block-local int32 index,
// signed value).
//
// Replaces the TPU kernels lbgm_sparse_decision_batched_pallas
// (src/repro/kernels/lbgm_sparse.py:69, one pass, entries in descending
// |value| order with ties to the lowest index — lax.top_k's rule) and
// lbgm_sparse_decision_two_pass_batched_pallas (:224, the same set per row
// in index order). `value_order` selects between the two.
//
// Input: the flat leaf (B, size), row r of client b being elements
// [r * block, (r + 1) * block) of the client's `size`; the (B, nb, block)
// layout is the case size = nb * block. Positions at or past `size` are
// zeros that are never read: pad rows (r * block >= size) write (iota, 0)
// and a zero gather, and a partly live row counts its virtual zeros at
// their true indices, so the result is the zero-padded layout's.
//
// Bound on an H100: bytes — B * size * sizeof(dtype) read once, the live
// rows' indices read, and 3 * B * nb * kb * 4 written, over the HBM rate.
// The selection does a handful of integer operations per element.
//
// Design: a cluster of CS CTAs per live row (CS = ceil(block / 8192), at
// most 8; a row of at most 8192 runs as a cluster of 1 with plain CTA
// barriers). One kernel a call; no full sort of the row.
//  * Each CTA loads its slice of the row (at most 8192 elements, 32 KB in
//    fp32) into shared memory once: the aligned middle with the TMA's 1-D
//    bulk copy on an mbarrier, a ragged head and tail with plain loads. The
//    LBG gathers and the pad rows' outputs are written while it flies.
//    Every later pass reads shared memory only.
//  * Select: a radix select on the 31-bit pattern of |g| (IEEE bits are
//    monotone in the magnitude, subnormals included) whose digits follow
//    the float: the exponent (bits 30..23), then mantissa bits 22..11 and
//    10..0. Pass 0: each CTA counts its slice into a private histogram and
//    adds its nonzero bins into every CTA's total through distributed
//    shared memory (DSMEM), so after one cluster barrier each CTA picks the
//    same exponent digit. The keys of that digit's bin (a few percent of a
//    gradient-like row) then go to rank 0, a region per CTA in index order;
//    rank 0 selects the two mantissa digits alone, counts each CTA's
//    entries above the threshold and ties, and sends every CTA the
//    threshold and the counts of the CTAs before it: two cluster barriers.
//    A bin too large for rank 0 (more than CAND_MAX keys: rows with few
//    distinct exponents) takes the mantissa passes on every CTA's slice,
//    with their totals summed through DSMEM, and an exchange of counts.
//  * Compact: in rank order (= index order) across the cluster, then each
//    warp walks its own run of the slice with ballots. Every entry above
//    the threshold is kept and the first `need` ties in index order — the
//    lowest-index tie rule. Index order writes each kept entry to its slot.
//    Value order writes sort keys (|g| descending, then index, carrying the
//    value): either every CTA receives all kb keys and places a share of
//    them at their ranks (the number of keys below; keys are unique), or
//    rank 0 receives them and sorts them (bitonic, at most SORT_MAX keys),
//    whichever has the shorter loop (placement_by_rank).
//  * Past SORT_MAX (value order at kb > 16384), the keys go to a global
//    scratch buffer instead and two more kernels sort them there:
//    sort_tiles_kernel sorts tiles of SORT_MAX keys in shared memory, then
//    merge_pass_kernel merges pairs of sorted runs by rank (a binary search
//    in the partner run). Only this path runs more than one kernel a call.
//  * A row whose largest |g| is 0 skips the select and compaction and
//    writes (iota, row[iota]) — what top-k gives for an all-zero row.
//  * ||g||^2: each CTA's slice sum (fixed tree), added in rank order by
//    the last rank into the row's partial; the last row of a client to
//    finish (a per-client ticket) adds the client's row partials in row
//    order and resets the ticket. No float atomics: the same bits on every
//    run.
//  * Residency: a CTA's shared memory is written by the others only before
//    a cluster barrier that every CTA of the cluster reaches; a CTA leaves
//    only after the last barrier whose writes reach it, and every branch
//    that leaves early (the all-zero row, index order) is taken by the whole
//    cluster.
//  * Measured on the H100 (PERF.md): merging equal bins with
//    __match_any_sync before the histogram atomic, and every CTA running
//    the mantissa passes on its slice, each cost more than what this design
//    does instead.
#include "common.cuh"

constexpr int SD_THREADS = 512;
constexpr int SD_WARPS = SD_THREADS / 32;
constexpr int CLUSTER_MAX = 8;   // portable cluster size
constexpr int SLICE = 8192;      // row elements per CTA
constexpr int BLOCK_MAX = CLUSTER_MAX * SLICE;
constexpr int SORT_MAX = 16384;  // keys sorted in shared memory (128 KB)
constexpr int RANK_BATCH = 8;    // keys a warp ranks at once
// radix digits: bits 30..23, 22..11, 10..0 of |g|
constexpr int NB0 = 256, NB1 = 4096, NB2 = 2048;
constexpr int SH0 = 23, SH1 = 11, SH2 = 0;
// a private histogram (NB1 words) and the three pass totals
constexpr int HIST_WORDS = NB1 + NB0 + NB1 + NB2;
// keys of the exponent digit's bin that rank 0 can gather (in place of the
// pass 1 and pass 2 totals)
constexpr int CAND_MAX = NB1 + NB2;

struct SdShared {
  unsigned long long bar;  // mbarrier of the bulk copy
  float ssp[CLUSTER_MAX];  // slice sums of ||g||^2 (the last rank's copy)
  int cnt_def[CLUSTER_MAX], cnt_tie[CLUSTER_MAX];  // per-rank counts
  int wdef[SD_WARPS], wtie[SD_WARPS];              // per-warp counts
  unsigned wsum[SD_WARPS];
  float fscratch[SD_WARPS];
  unsigned kmax;
  unsigned digit, above;
  // gathered select: this CTA's region of rank 0's candidates, and (rank
  // 0) every CTA's region, its count, its entries above the exponent
  // digit and its virtual zeros; rank 0's results, broadcast
  unsigned ncand, cbase;
  unsigned c_base[CLUSTER_MAX], c_cnt[CLUSTER_MAX], c_hi[CLUSTER_MAX],
      c_nvz[CLUSTER_MAX];
  unsigned thr, need;
  int def_base, tie_base;
};

template <typename T>
struct SdArgs {
  const T* g;
  long long size;  // live elements per client
  int nb, block, live, kb;
  int cs, slice, slice_bytes;  // cluster size, row elements per CTA
  int value_order, sort_p;     // sort_p: keys rank 0 sorts (power of two)
  int rank_sort;               // value order by ranks, not rank 0's sort
  const int* idx;
  float* gg_part;  // (B, live) row partials
  int* tickets;    // (B,) zero between calls
  float* gg;
  float* gathered;
  int* top_idx;
  float* top_val;
  unsigned long long* gkeys;  // value order past SORT_MAX, else null
};

__device__ __forceinline__ unsigned abs_key(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// The sort key of value v at index i: (~|v| bits, i, sign of v). Keys are
// unique, and ascending keys are |v| descending, then i ascending; the key
// gives back i and v exactly (key_index, key_value).
__device__ __forceinline__ unsigned long long sort_key(float v, int i) {
  const unsigned u = __float_as_uint(v);
  return ((unsigned long long)(~u | 0x80000000u) << 32) |
         ((unsigned)i << 1) | (u >> 31);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)((unsigned)key >> 1);
}
__device__ __forceinline__ float key_value(unsigned long long key) {
  return __uint_as_float((~(unsigned)(key >> 32) & 0x7fffffffu) |
                         ((unsigned)key << 31));
}

// Distributed shared memory: `p` is this CTA's copy of a shared variable;
// the operation lands on CTA `q` of the cluster's copy (a cluster of 1:
// this CTA's). One `mapa` and one shared::cluster access, no generic
// addressing.
__device__ __forceinline__ uint32_t dsmem(const void* p, int q) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(q));
  return r;
}
__device__ __forceinline__ void dsmem_add(unsigned* p, int q, unsigned v,
                                          int cs) {
  if (cs == 1) {
    atomicAdd(p, v);
    return;
  }
  asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(dsmem(p, q)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ void dsmem_max(unsigned* p, int q, unsigned v,
                                          int cs) {
  if (cs == 1) {
    atomicMax(p, v);
    return;
  }
  asm volatile("red.shared::cluster.max.u32 [%0], %1;" ::"r"(dsmem(p, q)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned dsmem_fetch_add(unsigned* p, int q,
                                                    unsigned v) {
  unsigned old;
  asm volatile("atom.shared::cluster.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(dsmem(p, q)), "r"(v)
               : "memory");
  return old;
}
template <typename U>
__device__ __forceinline__ void dsmem_store(U* p, int q, U v, int cs) {
  static_assert(sizeof(U) == 4 || sizeof(U) == 8, "32- or 64-bit stores");
  if (cs == 1) {
    *p = v;
  } else if constexpr (sizeof(U) == 4) {
    asm volatile("st.shared::cluster.b32 [%0], %1;" ::"r"(dsmem(p, q)),
                 "r"(*reinterpret_cast<uint32_t*>(&v))
                 : "memory");
  } else {
    asm volatile("st.shared::cluster.b64 [%0], %1;" ::"r"(dsmem(p, q)),
                 "l"(*reinterpret_cast<uint64_t*>(&v))
                 : "memory");
  }
}

// Every thread of every CTA of the cluster; a cluster of 1 needs only
// its CTA barrier.
__device__ __forceinline__ void cluster_sync(int cs) {
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// One count per participating lane into h[bin]. Lanes of a warp on one bin
// serialize in the shared-memory atomic unit; merging them first with
// __match_any_sync cost more than that on gradient-like data.
__device__ __forceinline__ void hist_add(unsigned* h, bool part,
                                         unsigned bin) {
  if (part) atomicAdd(&h[bin], 1u);
}

// Add this CTA's nonzero bins to the pass total of every CTA of the
// cluster; `clear` empties the private histogram for the next pass.
__device__ __forceinline__ void push_hist(unsigned* local, unsigned* tot,
                                          int nbins, int cs, bool clear) {
  for (int t = threadIdx.x; t < nbins; t += SD_THREADS) {
    const unsigned c = local[t];
    if (c) {
      if (clear) local[t] = 0;
      for (int q = 0; q < cs; ++q) dsmem_add(tot + t, q, c, cs);
    }
  }
}

// The digit d of the need-th largest key among those counted in `tot`
// (larger bins = larger |g|) and the number of counted keys whose digit is
// above d, into sh.digit and sh.above. Thread t owns bins [t * PER, t * PER
// + PER); a suffix scan over the threads finds the one bin.
template <int NB>
__device__ __forceinline__ void block_select(const unsigned* tot,
                                             unsigned need, SdShared& sh) {
  constexpr int PER = NB >= SD_THREADS ? NB / SD_THREADS : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = tid * PER;
  unsigned own = 0;
  if constexpr (PER % 4 == 0) {  // 16-byte loads: fewer bank conflicts
#pragma unroll
    for (int j = 0; j < PER; j += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(tot + b0 + j);
      own += v.x + v.y + v.z + v.w;
    }
  } else if (b0 < NB) {
#pragma unroll
    for (int j = 0; j < PER; ++j) own += tot[b0 + j];
  }
  unsigned incl = own;  // inclusive suffix sum over lanes >= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += t;
  }
  if (lane == 0) sh.wsum[warp] = incl;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < SD_WARPS; ++w)  // independent loads, no chain
    incl += w > warp ? sh.wsum[w] : 0u;
  const unsigned excl = incl - own;
  if (excl < need && incl >= need) {  // exactly one thread
    unsigned acc = excl;
    for (int j = PER - 1; j >= 0; --j) {
      const unsigned c = tot[b0 + j];
      if (acc + c >= need) {
        sh.digit = b0 + j;
        sh.above = acc;
        break;
      }
      acc += c;
    }
  }
  __syncthreads();
}

// Sort P (a power of two) keys ascending in shared memory, the CTA's
// SD_THREADS threads together, one compare-exchange per pair and step.
__device__ void bitonic_sort(unsigned long long* keys, int P) {
  for (int k2 = 2; k2 <= P; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < P / 2; q += SD_THREADS) {
        const int t = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int u = t | j;
        const unsigned long long x = keys[t], y = keys[u];
        if ((x > y) == ((t & k2) == 0)) {
          keys[t] = y;
          keys[u] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The last rank of a row's cluster, thread 0, with the row's ||g||^2
// partial: the client's last row adds the client's partials in row order.
template <typename T>
__device__ void finish_gg(const SdArgs<T>& a, int b, int r, float part) {
  if (a.live == 1) {
    a.gg[b] = part;
    return;
  }
  float* gp = a.gg_part + (long long)b * a.live;
  gp[r] = part;
  __threadfence();
  if (atomicAdd(&a.tickets[b], 1) != a.live - 1) return;
  __threadfence();
  float s = __ldcg(gp);
  for (int rr = 1; rr < a.live; ++rr) s += __ldcg(gp + rr);
  a.gg[b] = s;
  a.tickets[b] = 0;  // for the next call
}

template <typename T>
__global__ void __launch_bounds__(SD_THREADS)
    decision_kernel(const __grid_constant__ SdArgs<T> a) {
  __shared__ SdShared sh;
  extern __shared__ unsigned char dsm_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = a.cs, rank = blockIdx.x % cs;
  const int cid = blockIdx.x / cs;  // (client, live row)
  const int b = cid / a.live, r = cid % a.live;
  const long long rs = (long long)r * a.block;
  const int L = (int)min((long long)a.block, a.size - rs);  // live length
  const T* grow = a.g + (long long)b * a.size + rs;
  const long long ro = ((long long)b * a.nb + r) * a.kb;
  const int s0 = min(rank * a.slice, a.block);
  const int s1 = min(s0 + a.slice, a.block);
  const int n = max(0, min(s1, L) - s0);  // live elements of this slice
  const int vz0 = max(s0, L);             // its first virtual zero
  const int nvz = max(0, s1 - vz0);

  // dynamic shared memory, 128-byte aligned: the slice, then the
  // histograms, which value order's keys reuse once the select is done
  unsigned char* dsm =
      dsm_raw + ((128 - (smem_addr(dsm_raw) & 127)) & 127);
  T* sbuf = reinterpret_cast<T*>(dsm);
  unsigned* hist = reinterpret_cast<unsigned*>(dsm + a.slice_bytes);
  unsigned* tot0 = hist + NB1;
  unsigned* tot1 = tot0 + NB0;
  unsigned* tot2 = tot1 + NB1;
  auto* skeys = reinterpret_cast<unsigned long long*>(dsm + a.slice_bytes);

  // element j of the slice lands at sbuf[shift + j], so that the 16-byte
  // aligned middle of the global slice lands 16-byte aligned
  const uintptr_t src = reinterpret_cast<uintptr_t>(grow + s0);
  const int shift = (int)((src & 15) / sizeof(T));
  const int ja = min(n, (int)(((16 - (src & 15)) & 15) / sizeof(T)));
  const int jb =
      ja + (int)((long long)(n - ja) * sizeof(T) / 16 * 16 / sizeof(T));
  const uint32_t bytes = (uint32_t)((jb - ja) * sizeof(T));
  const uint32_t bar = smem_addr(&sh.bar);
  if (tid == 0) {
    mbarrier_init(bar, 1);
    sh.kmax = sh.ncand = 0;
  }
  // pass 0's histogram and total now; the rest before pass 0's barrier
  for (int i = tid; i < NB0; i += SD_THREADS) hist[i] = tot0[i] = 0;
  __syncthreads();
  // every CTA has started and zeroed its totals: others may add to them
  // once this barrier completes (arrived before the copy is issued: a
  // release after it would wait for the copy)
  if (cs > 1) cluster_arrive();
  if (tid == 0 && bytes) {
    mbarrier_expect_tx(bar, bytes);
    bulk_load(smem_addr(sbuf + shift + ja), grow + s0 + ja, bytes, bar);
  }
  for (int j = tid; j < ja; j += SD_THREADS) sbuf[shift + j] = grow[s0 + j];
  for (int j = jb + tid; j < n; j += SD_THREADS)
    sbuf[shift + j] = grow[s0 + j];

  // while the copy flies: g at the LBG positions (clamped into the row, as
  // a gather would be; past `size`, zeros), then the client's pad rows
  // (rows live..nb-1, one contiguous run of its outputs): (iota, 0) and a
  // zero gather. Each CTA writes a contiguous share of each, whole 32-byte
  // sectors but at the ends, so that a warp's stores are coalesced.
  const int kper = ((a.kb + cs - 1) / cs + 7) & ~7;
  const int k0 = min(a.kb, rank * kper), k1 = min(a.kb, k0 + kper);
  for (int j = k0 + tid; j < k1; j += SD_THREADS) {
    const int p = min(max(a.idx[ro + j], 0), a.block - 1);
    a.gathered[ro + j] = p < L ? to_f32(grow[p]) : 0.f;
  }
  {
    const int nct = a.live * cs, ct = r * cs + rank;  // the client's CTAs
    const int ptot = (a.nb - a.live) * a.kb;
    const int pper = ((ptot + nct - 1) / nct + 7) & ~7;
    const int p0 = min(ptot, ct * pper), p1 = min(ptot, p0 + pper);
    const long long pbase = ((long long)b * a.nb + a.live) * a.kb;
    const int inc = SD_THREADS % a.kb;  // j of entry e is e % kb
    int j = (p0 + tid) % a.kb;
    for (int e = p0 + tid; e < p1; e += SD_THREADS) {
      a.gathered[pbase + e] = 0.f;
      if (a.gkeys) {
        a.gkeys[pbase + e] = sort_key(0.f, j);
      } else {
        a.top_idx[pbase + e] = j;
        a.top_val[pbase + e] = 0.f;
      }
      j += inc;
      if (j >= a.kb) j -= a.kb;
    }
  }

  if (bytes) mbarrier_wait(bar, 0);
  __syncthreads();

  // pass 0: the slice's ||g||^2, its largest key, the exponent histogram
  // (a cluster of 1 counts straight into its total)
  unsigned* h0 = cs > 1 ? hist : tot0;
  float ss = 0.f;
  unsigned kmax = 0;
  for (int base = 0; base < n; base += SD_THREADS) {
    const int j = base + tid;
    const bool ok = j < n;
    const float v = ok ? to_f32(sbuf[shift + j]) : 0.f;
    ss = fmaf(v, v, ss);
    const unsigned k = abs_key(v);
    kmax = max(kmax, k);
    hist_add(h0, ok, k >> SH0);
  }
  if (tid == 0 && nvz) atomicAdd(&h0[0], (unsigned)nvz);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  for (int i = NB0 + tid; i < NB1; i += SD_THREADS) hist[i] = 0;
  for (int i = tid; i < NB1 + NB2; i += SD_THREADS) tot1[i] = 0;
  ss = block_sum<SD_THREADS>(ss, sh.fscratch);  // synchronises the CTA
  if (cs > 1) {
    cluster_wait();
    push_hist(hist, tot0, NB0, cs, false);
  }
  if (lane == 0 && kmax)
    for (int q = 0; q < cs; ++q) dsmem_max(&sh.kmax, q, kmax, cs);
  if (tid == 0) dsmem_store(&sh.ssp[rank], cs - 1, ss, cs);
  cluster_sync(cs);

  // the last rank adds the slice sums (rank 0, the gathered select's, is
  // the busiest)
  if (rank == cs - 1 && tid == 0) {
    float part = sh.ssp[0];
    for (int q = 1; q < cs; ++q) part += sh.ssp[q];
    finish_gg(a, b, r, part);
  }
  if (sh.kmax == 0) {  // all-zero row: top-k is (iota, row[iota])
    for (int j = k0 + tid; j < k1; j += SD_THREADS) {
      const float v = j < L ? to_f32(grow[j]) : 0.f;
      if (a.gkeys) {
        a.gkeys[ro + j] = sort_key(v, j);
      } else {
        a.top_idx[ro + j] = j;
        a.top_val[ro + j] = v;
      }
    }
    return;  // the whole cluster: no shared memory is written after this
  }

  // each warp's run of the slice, in index order
  const int run = ((n + SD_WARPS - 1) / SD_WARPS + 31) & ~31;
  const int w0 = min(n, warp * run), w1 = min(n, w0 + run);

  // radix select: prefix/mask hold the bits of the threshold fixed so far;
  // need is its rank among the keys that match them
  unsigned need = (unsigned)a.kb;
  block_select<NB0>(tot0, need, sh);
  const unsigned d0 = sh.digit;
  need -= sh.above;
  unsigned prefix = d0 << SH0, mask = 0xffu << SH0;
  // entries above the threshold and ties in the CTAs before this one
  int def_cta = 0, tie_cta = 0;
  const bool gathered = cs > 1 && tot0[d0] <= CAND_MAX;  // cluster-uniform
  if (gathered) {
    // the exponent digit's keys (a few percent of a gradient-like row) go
    // to rank 0, into a region per CTA; rank 0 selects the mantissa digits
    // alone, counts each CTA's entries above the threshold and ties, and
    // sends every CTA the threshold and its place
    unsigned* cand = tot1;
    if (tid == 0)
      sh.cbase = dsmem_fetch_add(&sh.ncand, 0,
                                 hist[d0] - (d0 == 0 ? nvz : 0));
    // each warp counts its run's keys of the bin and above it, then
    // writes the keys of the bin in index order
    int ncnt = 0, hcnt = 0;
    for (int base = w0; base < w1; base += 32) {
      const int j = base + lane;
      const unsigned k = j < w1 ? abs_key(to_f32(sbuf[shift + j])) : 0u;
      ncnt += __popc(__ballot_sync(0xffffffffu,
                                   j < w1 && (k & mask) == prefix));
      hcnt += __popc(__ballot_sync(0xffffffffu, j < w1 && (k >> SH0) > d0));
    }
    if (lane == 0) {
      sh.wdef[warp] = ncnt;
      sh.wtie[warp] = hcnt;
    }
    __syncthreads();
    for (int t = tid; t < NB0; t += SD_THREADS) hist[t] = 0;  // for rank 0
    const unsigned lt = (1u << lane) - 1u;
    unsigned at = sh.cbase;
#pragma unroll
    for (int w = 0; w < SD_WARPS; ++w) at += w < warp ? sh.wdef[w] : 0u;
    for (int base = w0; base < w1; base += 32) {
      const int j = base + lane;
      const unsigned k = j < w1 ? abs_key(to_f32(sbuf[shift + j])) : 0u;
      const bool m = j < w1 && (k & mask) == prefix;
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      if (m) dsmem_store(cand + at + __popc(bal & lt), 0, k, cs);
      at += __popc(bal);
    }
    if (tid == 0) {  // this CTA's region and counts, to rank 0
      unsigned cnt = 0, hi = 0;
      for (int w = 0; w < SD_WARPS; ++w) {
        cnt += sh.wdef[w];
        hi += sh.wtie[w];
      }
      dsmem_store(&sh.c_base[rank], 0, sh.cbase, cs);
      dsmem_store(&sh.c_cnt[rank], 0, cnt, cs);
      dsmem_store(&sh.c_hi[rank], 0, hi, cs);
      dsmem_store(&sh.c_nvz[rank], 0, (unsigned)nvz, cs);
    }
    cluster_sync(cs);
    if (rank == 0) {
      unsigned vz = 0;  // virtual zeros are keys of the bin when d0 == 0
      for (int q = 0; q < cs; ++q) vz += sh.c_nvz[q];
      for (int pass = 1; pass < 3; ++pass) {
        const int shift_d = pass == 1 ? SH1 : SH2;
        const unsigned nbm = pass == 1 ? NB1 - 1 : NB2 - 1;
        for (int j = tid; j < (int)sh.ncand; j += SD_THREADS) {
          const unsigned k = cand[j];
          hist_add(hist, (k & mask) == prefix, (k >> shift_d) & nbm);
        }
        if (tid == 0 && prefix == 0 && vz) atomicAdd(&hist[0], vz);
        __syncthreads();
        if (pass == 1)
          block_select<NB1>(hist, need, sh);
        else
          block_select<NB2>(hist, need, sh);
        need -= sh.above;
        prefix |= sh.digit << shift_d;
        mask |= nbm << shift_d;
        for (int t = tid; t <= (int)nbm; t += SD_THREADS) hist[t] = 0;
        __syncthreads();
      }
      if (warp < cs) {  // warp q counts CTA q's region
        int gt = 0, eq = 0;
        const int c0 = sh.c_base[warp], c1 = c0 + sh.c_cnt[warp];
        for (int j = c0 + lane; j < c1; j += 32) {
          gt += cand[j] > prefix;
          eq += cand[j] == prefix;
        }
        gt = __reduce_add_sync(0xffffffffu, gt);
        eq = __reduce_add_sync(0xffffffffu, eq);
        if (lane == 0) {
          sh.cnt_def[warp] = (int)sh.c_hi[warp] + gt;
          sh.cnt_tie[warp] = eq + (prefix == 0 ? (int)sh.c_nvz[warp] : 0);
        }
      }
      __syncthreads();
      if (tid == 0) {
        int d = 0, t = 0;
        for (int q = 0; q < cs; ++q) {
          dsmem_store(&sh.thr, q, prefix, cs);
          dsmem_store(&sh.need, q, need, cs);
          dsmem_store(&sh.def_base, q, d, cs);
          dsmem_store(&sh.tie_base, q, t, cs);
          d += sh.cnt_def[q];
          t += sh.cnt_tie[q];
        }
      }
    }
    cluster_sync(cs);
    prefix = sh.thr;
    need = sh.need;
    def_cta = sh.def_base;
    tie_cta = sh.tie_base;
  } else {
    // every CTA counts its slice; the totals are summed in every CTA
    for (int t = tid; t < NB0; t += SD_THREADS) hist[t] = 0;
    __syncthreads();
    for (int pass = 1; pass < 3; ++pass) {
      const int shift_d = pass == 1 ? SH1 : SH2;
      const unsigned nbm = pass == 1 ? NB1 - 1 : NB2 - 1;
      unsigned* tot = pass == 1 ? tot1 : tot2;
      unsigned* h = cs > 1 ? hist : tot;
      for (int base = 0; base < n; base += SD_THREADS) {
        const int j = base + tid;
        const unsigned k = j < n ? abs_key(to_f32(sbuf[shift + j])) : 0u;
        hist_add(h, j < n && (k & mask) == prefix, (k >> shift_d) & nbm);
      }
      if (tid == 0 && nvz && prefix == 0) atomicAdd(&h[0], (unsigned)nvz);
      if (cs > 1) {
        __syncthreads();
        push_hist(hist, tot, nbm + 1, cs, true);
      }
      cluster_sync(cs);
      if (pass == 1)
        block_select<NB1>(tot, need, sh);
      else
        block_select<NB2>(tot, need, sh);
      need -= sh.above;
      prefix |= sh.digit << shift_d;
      mask |= nbm << shift_d;
    }
  }
  const unsigned thr = prefix;  // the kb-th largest key
  const int ineed = (int)need;

  // compaction, 1: each warp counts its run of the slice
  int dcnt = 0, tcnt = 0;
  for (int base = w0; base < w1; base += 32) {
    const int j = base + lane;
    const unsigned k = j < w1 ? abs_key(to_f32(sbuf[shift + j])) : 0u;
    dcnt += __popc(__ballot_sync(0xffffffffu, j < w1 && k > thr));
    tcnt += __popc(__ballot_sync(0xffffffffu, j < w1 && k == thr));
  }
  if (lane == 0) {
    sh.wdef[warp] = dcnt;
    sh.wtie[warp] = tcnt;
  }
  __syncthreads();
  int live_def = 0, live_tie = 0;
  for (int w = 0; w < SD_WARPS; ++w) {
    live_def += sh.wdef[w];
    live_tie += sh.wtie[w];
  }
  const bool vz_ties = thr == 0 && nvz > 0;  // virtual zeros tie
  const bool shared_sort = a.value_order && !a.gkeys;
  if (shared_sort && !a.rank_sort && rank == 0)  // the sort's padding
    for (int s = a.kb + tid; s < a.sort_p; s += SD_THREADS) skeys[s] = ~0ull;
  if (!gathered) {  // the cluster-wide prefix of the CTAs' counts
    if (tid == 0)
      for (int q = 0; q < cs; ++q) {
        dsmem_store(&sh.cnt_def[rank], q, live_def, cs);
        dsmem_store(&sh.cnt_tie[rank], q, live_tie + (vz_ties ? nvz : 0),
                    cs);
      }
    cluster_sync(cs);
    for (int q = 0; q < rank; ++q) {
      def_cta += sh.cnt_def[q];
      tie_cta += sh.cnt_tie[q];
    }
  }

  // compaction, 2: the ranks before this one, then the warps before this
  // one, in index order
  int dbase = def_cta, tbase = tie_cta;
#pragma unroll
  for (int w = 0; w < SD_WARPS; ++w) {
    dbase += w < warp ? sh.wdef[w] : 0;
    tbase += w < warp ? sh.wtie[w] : 0;
  }
  auto emit = [&](int slot, int i, float v) {
    if (shared_sort) {  // to every CTA when they rank, else to rank 0
      for (int q = 0; q < (a.rank_sort ? cs : 1); ++q)
        dsmem_store(skeys + slot, q, sort_key(v, i), cs);
    } else if (a.gkeys) {
      a.gkeys[ro + slot] = sort_key(v, i);
    } else {
      a.top_idx[ro + slot] = i;
      a.top_val[ro + slot] = v;
    }
  };
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll 4
  for (int base = w0; base < w1; base += 32) {
    const int j = base + lane;
    const float v = j < w1 ? to_f32(sbuf[shift + j]) : 0.f;
    const unsigned k = abs_key(v);
    const bool is_def = j < w1 && k > thr;
    const bool is_tie = j < w1 && k == thr;
    const unsigned bd = __ballot_sync(0xffffffffu, is_def);
    const unsigned bt = __ballot_sync(0xffffffffu, is_tie);
    const int db = dbase + __popc(bd & lt), tb = tbase + __popc(bt & lt);
    if (is_def)
      emit(db + min(tb, ineed), s0 + j, v);
    else if (is_tie && tb < ineed)
      emit(db + tb, s0 + j, v);
    dbase += __popc(bd);
    tbase += __popc(bt);
  }
  if (vz_ties) {  // this slice's virtual zeros follow its live entries
    const int tb0 = tie_cta + live_tie, db0 = def_cta + live_def;
    for (int t = tid; t < min(nvz, ineed - tb0); t += SD_THREADS)
      emit(db0 + tb0 + t, vz0 + t, 0.f);
  }
  if (!shared_sort) return;  // no shared memory is written after this

  // value order: the keys are in place once the cluster has passed this
  // barrier
  cluster_sync(cs);
  auto out = [&](int s, unsigned long long key) {
    a.top_idx[ro + s] = key_index(key);
    a.top_val[ro + s] = key_value(key);
  };
  if (a.rank_sort) {
    // every CTA holds all kb keys and places a share of them: a key's slot
    // is the number of keys below it (they are unique); a warp counts for
    // RANK_BATCH keys at once
    const int per = (a.kb + cs - 1) / cs;
    const int c0 = rank * per, c1 = min(a.kb, c0 + per);
    for (int first = c0 + warp; first < c1;
         first += SD_WARPS * RANK_BATCH) {
      unsigned long long x[RANK_BATCH];
      int below[RANK_BATCH];
#pragma unroll
      for (int m = 0; m < RANK_BATCH; ++m) {
        const int s = first + m * SD_WARPS;
        x[m] = s < c1 ? skeys[s] : 0ull;
        below[m] = 0;
      }
#pragma unroll 4
      for (int j = lane; j < a.kb; j += 32) {
        const unsigned long long y = skeys[j];
#pragma unroll
        for (int m = 0; m < RANK_BATCH; ++m) below[m] += y < x[m];
      }
#pragma unroll
      for (int m = 0; m < RANK_BATCH; ++m) {
        const int at = __reduce_add_sync(0xffffffffu, below[m]);
        if (lane == m && first + m * SD_WARPS < c1) out(at, x[m]);
      }
    }
    return;
  }
  if (rank != 0) return;  // rank 0 sorts
  bitonic_sort(skeys, a.sort_p);
  for (int s = tid; s < a.kb; s += SD_THREADS) out(s, skeys[s]);
}

// Value order past SORT_MAX, step 1: sort each tile of SORT_MAX keys of a
// row in shared memory. grid (rows * tiles): blockIdx.x = row * tiles + t.
__global__ void __launch_bounds__(SD_THREADS) sort_tiles_kernel(
    unsigned long long* __restrict__ keys, int kb, int tiles) {
  extern __shared__ unsigned long long sort_keys[];
  const long long r = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * SORT_MAX;
  const int n = min(SORT_MAX, kb - t0);
  int P = 1;
  while (P < n) P <<= 1;
  unsigned long long* g = keys + r * kb + t0;
  for (int s = threadIdx.x; s < P; s += SD_THREADS)
    sort_keys[s] = s < n ? g[s] : ~0ull;
  __syncthreads();
  bitonic_sort(sort_keys, P);
  for (int s = threadIdx.x; s < n; s += SD_THREADS) g[s] = sort_keys[s];
}

// Step 2, one launch per doubling of the run: merge runs 2m and 2m + 1 of
// `width` sorted keys of every row. Key p of run q lands at the pair's
// start plus its offset in q plus the number of keys below it in the
// partner run (keys are unique). The last pass writes the indices and the
// values the keys carry instead of keys. grid covers rows * kb keys.
__global__ void __launch_bounds__(256) merge_pass_kernel(
    const unsigned long long* __restrict__ src,
    unsigned long long* __restrict__ dst, long long rows, int kb, int width,
    int* __restrict__ top_idx, float* __restrict__ top_val) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= rows * kb) return;
  const long long r = gid / kb;
  const int p = (int)(gid % kb);
  const unsigned long long* row = src + r * kb;
  const unsigned long long key = row[p];
  const int q = p / width, partner = q ^ 1;
  const int pstart = partner * width;
  int pos = p;
  if (pstart < kb) {
    int lo = pstart, hi = min(kb, pstart + width);  // first partner >= key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    pos = min(q, partner) * width + (p - q * width) + (lo - pstart);
  }
  if (top_idx) {
    top_idx[r * kb + pos] = key_index(key);
    top_val[r * kb + pos] = key_value(key);
  } else {
    dst[r * kb + pos] = key;
  }
}

// Value order's placement of the kept keys: 0 by placement_by_rank, 1
// ranks, 2 rank 0's bitonic sort (lbgm_sparse_decision_set_placement).
static int placement = 0;

// Whether value order places kb keys (sorted as P, a power of two) by
// their ranks in each of cs CTAs rather than by rank 0's bitonic sort:
// whichever has the shorter loop. Ranking: a warp counts the keys below
// RANK_BATCH keys of its CTA's share in one pass over all kb, 32 at a
// time. The sort: log P (log P + 1) / 2 steps of P / 2 compare-exchanges
// over the CTA's threads. On the H100 the rule picked the faster of the
// two at every shape timed (PERF.md).
static bool placement_by_rank(long long kb, long long P, int cs) {
  const long long share = (kb + cs - 1) / cs;
  const long long per_pass = SD_WARPS * RANK_BATCH;
  const long long rank_iters =
      (share + per_pass - 1) / per_pass * ((kb + 31) / 32);
  long long lg = 0;
  while ((1LL << lg) < P) ++lg;
  const long long sort_iters =
      lg * (lg + 1) / 2 * ((P / 2 + SD_THREADS - 1) / SD_THREADS);
  return rank_iters <= sort_iters;
}

// CTAs per row's cluster for a row of `block` elements.
static int cluster_for(long long block) {
  const long long cs = (block + SLICE - 1) / SLICE;
  return cs < CLUSTER_MAX ? (int)cs : CLUSTER_MAX;
}

template <typename T>
static cudaError_t launch(SdArgs<T> a, long long B,
                          unsigned long long* scratch, cudaStream_t s) {
  a.cs = cluster_for(a.block);
  a.slice = (int)(((a.block + a.cs - 1) / a.cs + 15) & ~15LL);
  a.slice_bytes = (int)((((long long)a.slice + 16 / sizeof(T)) * sizeof(T)
                         + 127) & ~127LL);
  const bool global_sort = a.value_order && a.kb > SORT_MAX;
  a.sort_p = 1;
  while (a.sort_p < a.kb) a.sort_p <<= 1;
  a.rank_sort = a.value_order && !global_sort &&
                (placement == 0 ? placement_by_rank(a.kb, a.sort_p, a.cs)
                                : placement == 1);
  const long long keys_bytes =
      a.value_order && !global_sort ? 8LL * a.sort_p : 0;
  const long long hist_bytes = 4LL * HIST_WORDS;
  const size_t smem = 128 + a.slice_bytes +
                      (size_t)(keys_bytes > hist_bytes ? keys_bytes
                                                       : hist_bytes);
  a.gkeys = global_sort ? scratch : nullptr;
  // set once per size (a host call per launch would cost the host-bound
  // rounds): the dynamic shared memory, and all of the SM's unified memory
  // as shared memory, so that two CTAs fit on an SM and every cluster of
  // the grid is resident in one wave
  static size_t smem_set[64] = {};  // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e ? e : cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(decision_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decision_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * a.live * a.cs));
  cfg.blockDim = dim3(SD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, decision_kernel<T>, a);
  if (e != cudaSuccess || !global_sort) return e;

  // the global sort ping-pongs between the scratch's two halves
  const long long rows = B * a.nb;
  unsigned long long* x = scratch;
  unsigned long long* y = scratch + rows * a.kb;
  const int smem_sort = SORT_MAX * (int)sizeof(unsigned long long);
  static bool sort_set[64] = {};
  if (!sort_set[dev]) {
    e = cudaFuncSetAttribute(sort_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_sort);
    if (e != cudaSuccess) return e;
    sort_set[dev] = true;
  }
  const int tiles = (a.kb + SORT_MAX - 1) / SORT_MAX;
  sort_tiles_kernel<<<(unsigned)(rows * tiles), SD_THREADS, smem_sort, s>>>(
      x, a.kb, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((rows * a.kb + 255) / 256);
  for (int width = SORT_MAX; width < a.kb; width *= 2) {
    const bool last = 2LL * width >= a.kb;
    merge_pass_kernel<<<grid, 256, 0, s>>>(
        x, y, rows, a.kb, width, last ? a.top_idx : nullptr,
        last ? a.top_val : nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    unsigned long long* t = x;
    x = y;
    y = t;
  }
  return cudaSuccess;
}

// The largest kb whose keys one CTA sorts in shared memory; value order
// past it sorts in the global scratch.
extern "C" long long lbgm_sparse_decision_shared_sort_kb() { return SORT_MAX; }

// Value order's placement of the kept keys from now on: 0 by the rule of
// placement_by_rank, 1 ranks in every CTA, 2 rank 0's bitonic sort (both
// give the same result); returns the previous setting, or -1 for another
// value. For measuring the two against each other.
extern "C" int lbgm_sparse_decision_set_placement(int p) {
  if (p < 0 || p > 2) return -1;
  const int old = placement;
  placement = p;
  return old;
}

// 1 when the rule places value order's kb keys by rank on a row of `block`.
extern "C" int lbgm_sparse_decision_places_by_rank(long long block,
                                                   long long kb) {
  long long P = 1;
  while (P < kb) P <<= 1;
  return placement_by_rank(kb, P, cluster_for(block));
}

// The largest block (row length) the kernel takes.
extern "C" long long lbgm_sparse_decision_block_max() { return BLOCK_MAX; }

// CTAs in the cluster of each live row of `block` elements.
extern "C" long long lbgm_sparse_decision_cluster_size(long long block) {
  return cluster_for(block);
}

// g: (B, size) contiguous, DT_F32 or DT_BF16; row r of client b is
// g[b, r * block : (r + 1) * block], zero past `size`; idx: (B, nb, kb)
// int32 block-local positions (clamped into the row). nb * block >= size.
// Outputs (contiguous): gg (B,), gathered (B, nb, kb) f32, top_idx
// (B, nb, kb) i32, top_val (B, nb, kb) f32. gg_part: B * ceil(size / block)
// floats of scratch; tickets: B ints, zero, left zero. scratch: 2 * B * nb
// * kb 64-bit keys when value_order and kb > SORT_MAX, else unused (may be
// null). Returns a cudaError_t.
extern "C" int lbgm_sparse_decision_launch(
    const void* g, int dtype, const int* idx, long long B, long long size,
    long long nb, long long block, long long kb, int value_order,
    float* gg_part, int* tickets, float* gg, float* gathered, int* top_idx,
    float* top_val, void* scratch, void* stream) {
  if (B < 1 || nb < 1 || size < 1 || block < 1 || block > BLOCK_MAX ||
      kb < 1 || kb > block)
    return cudaErrorInvalidValue;
  const long long live = (size + block - 1) / block;
  if (live > nb || B * nb > 0x7fffffffLL ||
      B * live * cluster_for(block) > 0x7fffffffLL ||
      B * nb * kb > (1LL << 40) || nb * kb > 0x7fffffffLL ||
      (value_order && kb > SORT_MAX && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(scratch);
  if (dtype == DT_F32) {
    SdArgs<float> a = {};
    a.g = static_cast<const float*>(g);
    a.size = size; a.nb = (int)nb; a.block = (int)block; a.live = (int)live;
    a.kb = (int)kb; a.value_order = value_order; a.idx = idx;
    a.gg_part = gg_part; a.tickets = tickets; a.gg = gg;
    a.gathered = gathered; a.top_idx = top_idx; a.top_val = top_val;
    return launch<float>(a, B, keys, s);
  }
  if (dtype == DT_BF16) {
    SdArgs<__nv_bfloat16> a = {};
    a.g = static_cast<const __nv_bfloat16*>(g);
    a.size = size; a.nb = (int)nb; a.block = (int)block; a.live = (int)live;
    a.kb = (int)kb; a.value_order = value_order; a.idx = idx;
    a.gg_part = gg_part; a.tickets = tickets; a.gg = gg;
    a.gathered = gathered; a.top_idx = top_idx; a.top_val = top_val;
    return launch<__nv_bfloat16>(a, B, keys, s);
  }
  return cudaErrorInvalidValue;
}
