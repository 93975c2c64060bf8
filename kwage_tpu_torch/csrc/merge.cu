// run_counts and merge_counts: the chunked device build's (word, count) runs.
//
// Replaces: the host side of kwage_tpu/pipeline/make_bloom.py
// build_bloom_device, numpy in the JAX package: each chunk's run starts and
// counts read back (digest, :222-229) and merged into the accumulated set
// by _merge_sorted_counts (:156: a concatenation, an argsort and an add.at a
// chunk), then thresholded on the host (:261).
//
// run_counts: sorted int64 words [n] (equal words adjacent), optional int32
// weights [n] (none: 1 each), a cap (1 .. 2^31 - 1) and min_count (0: no
// threshold) ->
//   words_out int64 [n]: the distinct words, in input order, at 0 .. num-1;
//   counts_out int32 [n]: each one's summed weight, saturating at cap;
//   stats int64 [2]: num, and the number of distinct words whose count is
//     >= min_count (0 when min_count is 0);
//   selected uint8 [n] (min_count > 0): count >= min_count, at 0 .. num-1.
// Entries from num on are left as they were. The caller passes cap =
// min_count: only count >= min_count is ever read, so a saturated count
// gives the same threshold, and int32 counts stay exact for it.
//
// merge_counts: two runs of distinct (word, count int32) pairs, each sorted
// [na], [nb] -> their merge [na + nb], sorted; a word of both runs lands
// twice, side by side, run A's pair first. The caller folds the pairs with
// run_counts (weights = the counts), which adds them; run_counts' look-back
// joins a pair that a tile edge splits.
//
// Words compare as signed int64, the port's sort order (at k = 32 the top
// bit is set for half the words).
//
// Bound: bytes. run_counts reads 8 bytes a position (12 with weights) and
// writes 12 a distinct word (13 with the threshold); merge_counts reads and
// writes 12 a pair. A few integer operations a position.
//
// Design:
//   run_counts: a block of 256 threads takes a tile of 2048 consecutive
//   positions, 8 a thread, in the order of an atomic ticket, so a tile only
//   ever waits on tiles whose blocks already run. A thread loads its 8
//   words (four 16-byte loads) and its weights into registers, takes the
//   word before them from the lane before (a shuffle; lane 0 reads it),
//   and flags the run starts; a block scan numbers them, and a decoupled
//   look-back over the tiles before (each publishes its count of starts,
//   then its inclusive prefix, which ends a later tile's walk; warp 0
//   reads 32 tiles a step) gives the tile's first run number. The thread
//   that holds a run's start sums the run alone, in registers and then,
//   where the run goes on past its 8 positions, from the array (the next
//   lanes' words, in L1), and stops at the run's end or at cap: no atomics
//   and no zeroing, and a run costs min(its length, cap) steps, cap or
//   less in the build (cap = min_count). The word, the count and the flag
//   go to shared memory at the run's number in the tile; the tile's runs
//   are consecutive numbers and leave in coalesced stores, and the block
//   adds its kept count with one atomic. The last tile writes num.
//   The first version staged the tile in shared memory (8 consecutive
//   int64 a thread: 16-way bank conflicts), added each thread's first and
//   last segment into zeroed counts with a saturating atomicCAS, walked
//   the look-back one tile a step and flagged in a second kernel: 0.5373
//   ms at a 46 Mbp accession against torch.unique_consecutive's 0.2974
//   (chip_smoke.py phase 4, NVIDIA H100 80GB HBM3, 700 W); stores of each
//   start straight from its thread (partial sectors) held the next
//   version at 0.3352-0.3389.
//   merge_counts: one binary search a tile of 2048 outputs on the merge path
//   (the partition kernel), then a block loads its pieces of A and B into
//   shared memory, each thread finds its 8 outputs' start on the path with
//   a binary search there and merges them serially, and the tile leaves
//   through shared memory in coalesced stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIpt = 8;                      // positions a thread
constexpr int kTile = kThreads * kIpt;       // positions a block: 2048
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Look-back word: bit 62 an aggregate, bit 63 an inclusive prefix, the
// low 62 bits the count; 0 is "not published yet".
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kValue = kAggregate - 1;

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
run_counts_kernel(const int64_t* __restrict__ words, const int32_t* __restrict__ weights,
                  int64_t* __restrict__ words_out, int32_t* __restrict__ counts_out,
                  uint8_t* __restrict__ selected, int64_t* __restrict__ stats,
                  unsigned long long* __restrict__ lookback, uint32_t* __restrict__ ticket,
                  int64_t n, int64_t num_tiles, uint32_t cap, uint32_t min_count,
                  int aligned) {
  __shared__ uint32_t s_wsum[kWarps];
  __shared__ uint32_t s_tile;
  __shared__ unsigned long long s_before;   // run starts in the tiles before
  __shared__ uint32_t s_kept;
  __shared__ int64_t s_ow[kTile];           // the tile's runs, staged for the stores
  __shared__ int32_t s_oc[kTile];
  __shared__ uint8_t s_os[kTile];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_tile = atomicAdd(ticket, 1u);
    s_kept = 0;
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t p0 = tile * kTile + t * kIpt;   // this thread's 8 positions

  int64_t w[kIpt];
  uint32_t wt[kIpt];
  if (aligned && p0 + kIpt <= n) {
    const longlong2* gw = reinterpret_cast<const longlong2*>(words + p0);
#pragma unroll
    for (int i = 0; i < kIpt / 2; ++i) {
      const longlong2 v = gw[i];
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
    if (weights) {
      const int4* gc = reinterpret_cast<const int4*>(weights + p0);
#pragma unroll
      for (int i = 0; i < kIpt / 4; ++i) {
        const int4 v = gc[i];
        wt[4 * i] = v.x;
        wt[4 * i + 1] = v.y;
        wt[4 * i + 2] = v.z;
        wt[4 * i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      w[i] = p0 + i < n ? words[p0 + i] : 0;
      if (weights) wt[i] = p0 + i < n ? (uint32_t)weights[p0 + i] : 0u;
    }
  }
  if (!weights) {
#pragma unroll
    for (int i = 0; i < kIpt; ++i) wt[i] = 1;
  }
  // The word before this thread's first: the lane before's last, or (lane
  // 0) one read of the array.
  const int64_t from_left = __shfl_up_sync(kFull, w[kIpt - 1], 1);
  const int64_t before_first =
      lane ? from_left : (p0 > 0 && p0 <= n ? words[p0 - 1] : 0);

  uint32_t flags = 0, nflags = 0;
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    const int64_t p = p0 + i;
    if (p < n && (p == 0 || w[i] != (i ? w[i - 1] : before_first))) {
      flags |= 1u << i;
      ++nflags;
    }
  }
  const uint32_t inc = warp_inclusive_scan(nflags, lane);
  if (lane == 31) s_wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t v = warp_inclusive_scan(lane < kWarps ? s_wsum[lane] : 0u, lane);
    if (lane < kWarps) s_wsum[lane] = v;
  }
  __syncthreads();
  const uint32_t excl = inc - nflags + (warp ? s_wsum[warp - 1] : 0u);
  const uint32_t total = s_wsum[kWarps - 1];

  // The look-back, by warp 0: lane l reads the tile l + 1 before the
  // window's top, so a walk takes 32 tiles a step; the nearest inclusive
  // prefix ends it.
  if (warp == 0) {
    volatile unsigned long long* mine = lookback + tile;
    unsigned long long before = 0;
    if (tile == 0) {
      if (lane == 0) *mine = kPrefix | total;
    } else {
      if (lane == 0) *mine = kAggregate | total;
      for (int64_t top = tile - 1;; top -= 32) {
        const int64_t q = top - lane;
        unsigned long long v = kPrefix;    // before tile 0: a prefix of 0
        if (q >= 0) {
          do {
            v = *(volatile unsigned long long*)(lookback + q);
          } while (v == 0);
        }
        const unsigned prefixes = __ballot_sync(kFull, (v & kPrefix) != 0);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        unsigned long long val = lane <= stop ? (v & kValue) : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) val += __shfl_down_sync(kFull, val, o);
        before += __shfl_sync(kFull, val, 0);
        if (prefixes) break;
      }
      if (lane == 0) *mine = kPrefix | (before + total);
    }
    if (lane == 0) {
      s_before = before;
      if (tile == num_tiles - 1) stats[0] = (int64_t)(before + total);
    }
  }
  __syncthreads();

  // Each run start: its number, its word, and its weights summed up to the
  // run's end or to cap, past this thread's positions where the run goes on.
  uint32_t run = excl;                      // the run's number in the tile
  uint32_t kept = 0;
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    if (!(flags >> i & 1u)) continue;
    uint64_t sum = wt[i];
    int j = i + 1;
#pragma unroll
    for (int q = 1; q < kIpt; ++q)
      if (j == i + q && i + q < kIpt && p0 + i + q < n && sum < cap && w[i + q] == w[i]) {
        sum += wt[i + q];
        ++j;
      }
    if (j == kIpt) {
      for (int64_t q = p0 + kIpt; q < n && sum < cap && words[q] == w[i]; ++q)
        sum += weights ? (uint32_t)weights[q] : 1u;
    }
    const uint32_t count = sum < cap ? (uint32_t)sum : cap;
    s_ow[run] = w[i];
    s_oc[run] = (int32_t)count;
    const bool keep = count >= min_count;
    s_os[run] = keep;
    kept += keep;
    ++run;
  }
  if (min_count) {
    kept = __reduce_add_sync(kFull, kept);
    if (lane == 0 && kept) atomicAdd(&s_kept, kept);
  }
  __syncthreads();
  // The tile's runs are numbers before .. before + total - 1: coalesced.
  const int64_t first = (int64_t)s_before;
  for (uint32_t j = t; j < total; j += kThreads) {
    words_out[first + j] = s_ow[j];
    counts_out[first + j] = s_oc[j];
    if (min_count) selected[first + j] = s_os[j];
  }
  if (min_count && t == 0 && s_kept)
    atomicAdd(reinterpret_cast<unsigned long long*>(stats + 1), (unsigned long long)s_kept);
}

// The number of run A's pairs among the first d of the merge (run A's pair
// first on equal words): the merge path's crossing of diagonal d.
__device__ __forceinline__ int64_t merge_path(const int64_t* a, int64_t na, const int64_t* b,
                                              int64_t nb, int64_t d) {
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void merge_partition_kernel(const int64_t* __restrict__ wa, int64_t na,
                                       const int64_t* __restrict__ wb, int64_t nb,
                                       int64_t* __restrict__ part, int64_t num_tiles) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > num_tiles) return;
  const int64_t d = i * kTile < na + nb ? i * kTile : na + nb;
  part[i] = merge_path(wa, na, wb, nb, d);
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int64_t* __restrict__ wa, const int32_t* __restrict__ ca, int64_t na,
             const int64_t* __restrict__ wb, const int32_t* __restrict__ cb, int64_t nb,
             const int64_t* __restrict__ part, int64_t* __restrict__ w_out,
             int32_t* __restrict__ c_out) {
  __shared__ int64_t s_w[kTile];            // run A's piece, then run B's
  __shared__ int32_t s_c[kTile];
  const int t = threadIdx.x;
  const int64_t tile = blockIdx.x, d0 = tile * kTile, n = na + nb;
  const int64_t d1 = d0 + kTile < n ? d0 + kTile : n;
  const int64_t a0 = part[tile], a1 = part[tile + 1];
  const int64_t b0 = d0 - a0;
  const int la = (int)(a1 - a0), len = (int)(d1 - d0), lb = len - la;
  for (int j = t; j < len; j += kThreads) {
    if (j < la) {
      s_w[j] = wa[a0 + j];
      s_c[j] = ca[a0 + j];
    } else {
      s_w[j] = wb[b0 + j - la];
      s_c[j] = cb[b0 + j - la];
    }
  }
  __syncthreads();
  const int dt = t * kIpt < len ? t * kIpt : len;
  int ia = (int)merge_path(s_w, la, s_w + la, lb, dt), ib = dt - ia;
  int64_t ow[kIpt];
  int32_t oc[kIpt];
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    if (dt + i < len) {
      const bool take_a = ib >= lb || (ia < la && s_w[ia] <= s_w[la + ib]);
      const int src = take_a ? ia++ : la + ib++;
      ow[i] = s_w[src];
      oc[i] = s_c[src];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kIpt; ++i) {
    if (dt + i < len) {
      s_w[dt + i] = ow[i];
      s_c[dt + i] = oc[i];
    }
  }
  __syncthreads();
  for (int j = t; j < len; j += kThreads) {
    w_out[d0 + j] = s_w[j];
    c_out[d0 + j] = s_c[j];
  }
}

int grid_for(int64_t items, int per_block, int64_t most) {
  const int64_t blocks = (items + per_block - 1) / per_block;
  return (int)(blocks < most ? (blocks < 1 ? 1 : blocks) : most);
}

}  // namespace

// scratch: uint64 [ceil(n / 2048) + 1] (the look-back words, then the
// ticket); counts_out must not alias words_out. weights, selected: may be
// null (selected must not be when min_count > 0).
extern "C" int kw_run_counts(const void* words, const void* weights, void* words_out,
                             void* counts_out, void* selected, void* stats, void* scratch,
                             int64_t n, int64_t cap, int64_t min_count, void* stream) {
  if (n < 0 || cap < 1 || cap > 0x7fffffff || min_count < 0 || min_count > cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(stats, 0, 2 * sizeof(int64_t), s)) return (int)err;
  if (n == 0) return 0;
  if (min_count > 0 && selected == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 8, s)) return (int)err;
  unsigned long long* lookback = (unsigned long long*)scratch;
  const int aligned = (((uintptr_t)words | (uintptr_t)weights) & 15) == 0;
  run_counts_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const int64_t*)words, (const int32_t*)weights, (int64_t*)words_out,
      (int32_t*)counts_out, (uint8_t*)selected, (int64_t*)stats, lookback,
      (uint32_t*)(lookback + tiles), n, tiles, (uint32_t)cap, (uint32_t)min_count, aligned);
  return (int)cudaGetLastError();
}

// part: int64 [ceil((na + nb) / 2048) + 1]. words_out / counts_out hold
// na + nb pairs.
extern "C" int kw_merge_counts(const void* words_a, const void* counts_a, const void* words_b,
                               const void* counts_b, void* words_out, void* counts_out,
                               void* part, int64_t na, int64_t nb, void* stream) {
  if (na < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  const int64_t n = na + nb;
  if (n == 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  merge_partition_kernel<<<grid_for(tiles + 1, kThreads, 1LL << 30), kThreads, 0, s>>>(
      (const int64_t*)words_a, na, (const int64_t*)words_b, nb, (int64_t*)part, tiles);
  merge_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      (const int64_t*)words_a, (const int32_t*)counts_a, na, (const int64_t*)words_b,
      (const int32_t*)counts_b, nb, (const int64_t*)part, (int64_t*)words_out,
      (int32_t*)counts_out);
  return (int)cudaGetLastError();
}
