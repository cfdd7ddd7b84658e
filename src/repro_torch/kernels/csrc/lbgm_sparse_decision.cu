// Fused sparse-LBG decision: per (client, block row) of a (B, nb, block)
// gradient block layout, in one kernel, the row's partial ||g||^2, g
// gathered at the LBG's block-local indices, and the row's top-kb entries
// by |g| (block-local int32 index, signed value).
//
// Replaces the TPU kernels lbgm_sparse_decision_batched_pallas
// (src/repro/kernels/lbgm_sparse.py:69, one pass, entries in descending
// |value| order with ties to the lowest index — lax.top_k's rule) and
// lbgm_sparse_decision_two_pass_batched_pallas (:224, the same set per row
// in index order). `value_order` selects between the two.
//
// Bound on an H100: bytes — B * nb * block * sizeof(dtype) read once, the
// indices B * nb * kb * 4 read, and 3 * B * nb * kb * 4 written, over the
// HBM rate. The selection does a handful of integer operations per element.
//
// Design: one CTA of 1024 threads per (client, row); no full sort of the
// row.
//  * Select: a radix select on the 31-bit pattern of |g| (IEEE bits are
//    monotone in the magnitude, so every magnitude, subnormals included,
//    resolves exactly). Four passes of 8 bits, each a histogram in shared
//    memory (one private histogram per warp, then summed), give the bit
//    pattern thr of the kb-th largest |g| and the number `need` of entries
//    equal to thr that the top-kb takes.
//  * Compact: a block-wide prefix count in index order over tiles of 1024
//    entries (warp ballots, then one warp scans the 32 warp counts). Every
//    entry above thr is kept, and the first `need` entries equal to thr — the
//    lowest-index tie rule. A row with fewer than kb nonzeros therefore
//    keeps every nonzero. Index order writes each kept entry straight to
//    its slot. Value order writes (~|g| bits, index) keys — unique, since
//    the index is in them — and sorts them ascending: |g| descending, the
//    lower index first among equal |g|. Up to SORT_MAX keys (128 KB) are
//    sorted with a bitonic sort in the CTA's shared memory.
//  * Past SORT_MAX (value order at kb > 16384: a top-k store with k_frac >
//    0.25 on 65536-wide blocks), the keys go to a global scratch buffer
//    instead, and the row is sorted there: sort_tiles_kernel sorts tiles
//    of SORT_MAX keys in shared memory (the same bitonic sort), then
//    merge_pass_kernel merges pairs of sorted runs, doubling the run, each
//    key placed at its run offset plus its rank in the partner run (a
//    binary search; keys are unique, so the ranks make a permutation). The
//    last merge writes the indices and the values. No library sort.
//  * A row whose largest |g| is 0 (the layout's padding rows: nb is
//    rounded up to a multiple of 16) skips the select and compaction and
//    writes (iota, row[iota]) — what top-k gives for an all-zero row.
//  * The row's ||g||^2 partial comes from the first pass; a second launch
//    (row_sum_kernel) adds each client's row partials in row order.
// A row is up to 65536 fp32 values, 256 KB — more than the 227 KB of shared
// memory a CTA can hold — so the four select passes and the compaction
// re-read it from L2 (50 MB, enough for 132 rows in flight) rather than
// from HBM.
#include "common.cuh"

constexpr int SD_THREADS = 1024;
constexpr int SD_WARPS = SD_THREADS / 32;
constexpr int RADIX = 256;
constexpr int SORT_MAX = 16384;  // keys sorted in shared memory (128 KB)

struct SdShared {
  unsigned hist[SD_WARPS][RADIX];  // 32 KB
  float fscratch[SD_WARPS];
  unsigned kmax[SD_WARPS];
  int def_cnt[SD_WARPS], tie_cnt[SD_WARPS];
  int def_off[SD_WARPS], tie_off[SD_WARPS];
  int def_tot, tie_tot;
  unsigned digit, above;
};

__device__ __forceinline__ unsigned abs_key(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ void clear_hist(SdShared& sh) {
  unsigned* h = &sh.hist[0][0];
  for (int i = threadIdx.x; i < SD_WARPS * RADIX; i += SD_THREADS) h[i] = 0;
}

// Warp 0: the digit d of the need-th largest key among those counted in
// `hist` (bins 255..0, larger bins = larger |g|), and the number of counted
// keys whose digit is above d.
__device__ __forceinline__ void select_digit(const unsigned* hist,
                                             unsigned need, int lane,
                                             unsigned* digit,
                                             unsigned* above) {
  unsigned own = 0;  // lane L owns bins [8L, 8L + 8)
#pragma unroll
  for (int j = 0; j < 8; ++j) own += hist[lane * 8 + j];
  unsigned incl = own;  // inclusive suffix sum over lanes >= L
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += t;
  }
  const unsigned excl = incl - own;
  if (excl < need && incl >= need) {  // exactly one lane
    unsigned acc = excl;
    for (int j = 7; j >= 0; --j) {
      const unsigned c = hist[lane * 8 + j];
      if (acc + c >= need) {
        *digit = lane * 8 + j;
        *above = acc;
        break;
      }
      acc += c;
    }
  }
}

// Sort n <= SORT_MAX keys ascending in shared memory (padded to a power
// of two with ~0), the CTA's SD_THREADS threads together.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int s = n + threadIdx.x; s < P; s += SD_THREADS) keys[s] = ~0ull;
  __syncthreads();
  for (int k2 = 2; k2 <= P; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P; t += SD_THREADS) {
        const int u = t ^ j;
        if (u > t) {
          const unsigned long long a = keys[t], b = keys[u];
          if ((a > b) == ((t & k2) == 0)) {
            keys[t] = b;
            keys[u] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SD_THREADS, 1) sparse_decision_kernel(
    const T* __restrict__ blocks, const int* __restrict__ idx, int block,
    int kb, int value_order, float* __restrict__ gg_partial,
    float* __restrict__ gathered, int* __restrict__ top_idx,
    float* __restrict__ top_val, unsigned long long* __restrict__ gkeys) {
  __shared__ SdShared sh;
  extern __shared__ unsigned long long sort_keys[];
  const long long r = blockIdx.x;  // flattened (client, row)
  const T* row = blocks + r * block;
  const int* ri = idx + r * kb;
  float* gath = gathered + r * kb;
  int* ti = top_idx + r * kb;
  float* tv = top_val + r * kb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // g at the LBG positions (clamped into the row, as a gather would be)
  for (int j = tid; j < kb; j += SD_THREADS)
    gath[j] = to_f32(row[min(max(ri[j], 0), block - 1)]);

  // pass 0: ||g||^2 partial, the largest key, histogram of bits 31..24
  clear_hist(sh);
  __syncthreads();
  float ss = 0.f;
  unsigned kmax = 0;
  for (int i = tid; i < block; i += SD_THREADS) {
    const float v = to_f32(row[i]);
    ss = fmaf(v, v, ss);
    const unsigned k = abs_key(v);
    kmax = max(kmax, k);
    atomicAdd(&sh.hist[warp][k >> 24], 1u);
  }
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  if (lane == 0) sh.kmax[warp] = kmax;
  ss = block_sum<SD_THREADS>(ss, sh.fscratch);  // synchronises the CTA
  if (tid == 0) gg_partial[r] = ss;
  kmax = 0;
  for (int w = 0; w < SD_WARPS; ++w) kmax = max(kmax, sh.kmax[w]);
  // value order past SORT_MAX: this row's keys go to global scratch
  unsigned long long* keys = gkeys ? gkeys + r * kb : sort_keys;
  if (kmax == 0) {  // all-zero row: top-k is (iota, row[iota])
    for (int j = tid; j < kb; j += SD_THREADS) {
      if (gkeys) {  // the keys of |g| = 0 at 0..kb-1, sorted later
        keys[j] = (0xffffffffull << 32) | (unsigned)j;
      } else {
        ti[j] = j;
        tv[j] = to_f32(row[j]);
      }
    }
    return;
  }

  // radix select: prefix/mask hold the bits of thr fixed so far; need is
  // the rank of thr among the keys that match them
  unsigned prefix = 0, mask = 0, need = (unsigned)kb;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (pass > 0) {
      clear_hist(sh);
      __syncthreads();
      for (int i = tid; i < block; i += SD_THREADS) {
        const unsigned k = abs_key(to_f32(row[i]));
        if ((k & mask) == prefix)
          atomicAdd(&sh.hist[warp][(k >> shift) & 0xffu], 1u);
      }
      __syncthreads();
    }
    if (tid < RADIX) {  // thread t alone owns column t of every histogram
      unsigned c = 0;
      for (int w = 0; w < SD_WARPS; ++w) c += sh.hist[w][tid];
      sh.hist[0][tid] = c;
    }
    __syncthreads();
    if (warp == 0) select_digit(sh.hist[0], need, lane, &sh.digit, &sh.above);
    __syncthreads();
    need -= sh.above;
    prefix |= sh.digit << shift;
    mask |= 0xffu << shift;
  }
  const unsigned thr = prefix;  // the kb-th largest key
  const int m = kb - (int)need;  // entries strictly above thr

  // compaction in index order
  const unsigned lt = (1u << lane) - 1u;
  int def_base = 0, tie_base = 0;
  for (int base = 0; base < block; base += SD_THREADS) {
    const int i = base + tid;
    float v = 0.f;
    unsigned k = 0;
    if (i < block) {
      v = to_f32(row[i]);
      k = abs_key(v);
    }
    const bool is_def = i < block && k > thr;
    const bool is_tie = i < block && k == thr;
    const unsigned bd = __ballot_sync(0xffffffffu, is_def);
    const unsigned bt = __ballot_sync(0xffffffffu, is_tie);
    if (lane == 0) {
      sh.def_cnt[warp] = __popc(bd);
      sh.tie_cnt[warp] = __popc(bt);
    }
    __syncthreads();
    if (warp == 0) {
      const int dc = sh.def_cnt[lane], tc = sh.tie_cnt[lane];
      int di = dc, tci = tc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, di, off);
        const int b = __shfl_up_sync(0xffffffffu, tci, off);
        if (lane >= off) {
          di += a;
          tci += b;
        }
      }
      sh.def_off[lane] = di - dc;
      sh.tie_off[lane] = tci - tc;
      if (lane == 31) {
        sh.def_tot = di;
        sh.tie_tot = tci;
      }
    }
    __syncthreads();
    const int def_before = def_base + sh.def_off[warp] + __popc(bd & lt);
    const int tie_before = tie_base + sh.tie_off[warp] + __popc(bt & lt);
    int slot = -1;
    if (is_def)
      slot = def_before + min(tie_before, (int)need);
    else if (is_tie && tie_before < (int)need)
      slot = def_before + tie_before;
    if (slot >= 0) {
      if (value_order) {
        keys[slot] = ((unsigned long long)(~k) << 32) | (unsigned)i;
      } else {
        ti[slot] = i;
        tv[slot] = v;
      }
    }
    def_base += sh.def_tot;
    tie_base += sh.tie_tot;
    if (def_base == m && tie_base >= (int)need) break;  // all placed
  }
  if (!value_order || gkeys) return;

  // value order: sort the kb keys ascending = |g| descending, index
  // ascending among equal |g|
  __syncthreads();
  bitonic_sort(sort_keys, kb);
  for (int s = tid; s < kb; s += SD_THREADS) {
    const int i = (int)(sort_keys[s] & 0xffffffffull);
    ti[s] = i;
    tv[s] = to_f32(row[i]);
  }
}

// Value order past SORT_MAX, step 1: sort each tile of SORT_MAX keys of a
// row in shared memory. grid (rows * tiles): blockIdx.x = row * tiles + t.
__global__ void __launch_bounds__(SD_THREADS, 1) sort_tiles_kernel(
    unsigned long long* __restrict__ keys, int kb, int tiles) {
  extern __shared__ unsigned long long sort_keys[];
  const long long r = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * SORT_MAX;
  const int n = min(SORT_MAX, kb - t0);
  unsigned long long* g = keys + r * kb + t0;
  for (int s = threadIdx.x; s < n; s += SD_THREADS) sort_keys[s] = g[s];
  __syncthreads();
  bitonic_sort(sort_keys, n);
  for (int s = threadIdx.x; s < n; s += SD_THREADS) g[s] = sort_keys[s];
}

// Step 2, one launch per doubling of the run: merge runs 2m and 2m + 1 of
// `width` sorted keys of every row. Key p of run q lands at the pair's
// start plus its offset in q plus the number of keys below it in the
// partner run (keys are unique). The last pass writes the indices and the
// values instead of keys. grid covers rows * kb keys.
template <typename T>
__global__ void __launch_bounds__(256) merge_pass_kernel(
    const unsigned long long* __restrict__ src,
    unsigned long long* __restrict__ dst, long long rows, int kb, int width,
    const T* __restrict__ blocks, int block, int* __restrict__ top_idx,
    float* __restrict__ top_val) {
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
    const int i = (int)(key & 0xffffffffull);
    top_idx[r * kb + pos] = i;
    top_val[r * kb + pos] = to_f32(blocks[r * block + i]);
  } else {
    dst[r * kb + pos] = key;
  }
}

template <typename T>
static cudaError_t launch_rows(const void* blocks, const int* idx,
                               long long rows, int block, int kb,
                               int value_order, float* gg_partial,
                               float* gathered, int* top_idx, float* top_val,
                               unsigned long long* scratch, cudaStream_t s) {
  const int smem_max = SORT_MAX * (int)sizeof(unsigned long long);
  cudaError_t e = cudaFuncSetAttribute(
      sparse_decision_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_max);
  if (e != cudaSuccess) return e;
  const bool global_sort = value_order && kb > SORT_MAX;
  size_t P = 1;
  while (P < (size_t)kb) P <<= 1;
  const size_t smem =
      value_order && !global_sort ? P * sizeof(unsigned long long) : 0;
  // the global sort ping-pongs between the scratch's two halves
  unsigned long long* a = global_sort ? scratch : nullptr;
  unsigned long long* b = a ? a + rows * kb : nullptr;
  sparse_decision_kernel<T><<<(unsigned)rows, SD_THREADS, smem, s>>>(
      static_cast<const T*>(blocks), idx, block, kb, value_order, gg_partial,
      gathered, top_idx, top_val, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || !global_sort) return e;
  e = cudaFuncSetAttribute(sort_tiles_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_max);
  if (e != cudaSuccess) return e;
  const int tiles = (kb + SORT_MAX - 1) / SORT_MAX;
  sort_tiles_kernel<<<(unsigned)(rows * tiles), SD_THREADS, smem_max, s>>>(
      a, kb, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = rows * kb;
  const unsigned grid = (unsigned)((n + 255) / 256);
  for (int width = SORT_MAX; width < kb; width *= 2) {
    const bool last = 2LL * width >= kb;
    merge_pass_kernel<T><<<grid, 256, 0, s>>>(
        a, b, rows, kb, width, static_cast<const T*>(blocks), block,
        last ? top_idx : nullptr, last ? top_val : nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    unsigned long long* t = a;
    a = b;
    b = t;
  }
  return cudaSuccess;
}

// The largest kb whose keys one CTA sorts in shared memory; value order
// past it sorts in the global scratch.
extern "C" long long lbgm_sparse_decision_shared_sort_kb() { return SORT_MAX; }

// blocks: (B, nb, block) contiguous, DT_F32 or DT_BF16; idx: (B, nb, kb)
// int32 in [0, block). Outputs (all contiguous): gg_partial (B, nb) scratch,
// gg (B,), gathered (B, nb, kb) f32, top_idx (B, nb, kb) i32, top_val
// (B, nb, kb) f32. scratch: 2 * B * nb * kb 64-bit keys when value_order
// and kb > SORT_MAX, else unused (may be null). Returns a cudaError_t.
extern "C" int lbgm_sparse_decision_launch(
    const void* blocks, int dtype, const int* idx, long long B, long long nb,
    long long block, long long kb, int value_order, float* gg_partial,
    float* gg, float* gathered, int* top_idx, float* top_val, void* scratch,
    void* stream) {
  if (B < 1 || nb < 1 || kb < 1 || kb > block || block > 0x7fffffffLL ||
      B * nb > 0x7fffffffLL || B * nb * kb > (1LL << 40) ||
      (value_order && kb > SORT_MAX && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* keys = static_cast<unsigned long long*>(scratch);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_rows<float>(blocks, idx, B * nb, (int)block, (int)kb,
                           value_order, gg_partial, gathered, top_idx,
                           top_val, keys, s);
  else if (dtype == DT_BF16)
    e = launch_rows<__nv_bfloat16>(blocks, idx, B * nb, (int)block, (int)kb,
                                   value_order, gg_partial, gathered,
                                   top_idx, top_val, keys, s);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  row_sum_kernel<<<(unsigned)B, ROW_SUM_THREADS, 0, s>>>(gg_partial, gg, nb);
  return cudaGetLastError();
}
