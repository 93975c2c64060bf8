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
// [na], [nb] -> run_counts' outputs over their union, in one pass: the
// distinct words, sorted, the counts of a word in both runs added
// (saturating at cap), stats and the selected flags.
//
// Words compare as signed int64, the port's sort order (at k = 32 the top
// bit is set for half the words).
//
// Bound: bytes. run_counts reads 8 bytes a position (12 with weights) and
// writes 12 a distinct word (13 with the threshold); merge_counts reads 12
// a pair and writes 12 (13) a distinct word. A few integer operations a
// position.
//
// Design: persistent blocks over a ring of tiles fed by TMA, both kernels.
//   A block takes one SM (193 KB of shared memory) and has three roles: a
//   producer lane, 16 consumer warps and 4 storer warps in two groups. The
//   producer takes tiles of 4096 positions by an atomic ticket, claimed one
//   tile ahead (so a tile only ever waits on tiles that running blocks
//   hold), and fills a ring of two input stages with 1-D bulk copies
//   (cp.async.bulk global -> shared, completing on the stage's "full"
//   mbarrier): the next tile's bytes are on their way while the consumers
//   work on one. The consumers number the tile's distinct words with a
//   block scan, publish the tile's count for the look-back at once (an
//   atomic add into the zeroed word, which no thread waits for), stage the
//   tile's words in an output buffer of their own and hand it to a storer
//   group (mbarriers "staged" and "free"), then the input stage back to the
//   producer ("empty"). A storer group finds the tile's place with a
//   decoupled look-back (32 tiles a row, up to 256 a step, waiting on a
//   row's counts only if no nearer row holds an inclusive prefix; the
//   block's own previous tile, some 132 tiles back, always has one), turns
//   the tile's aggregate into its inclusive prefix with one add, and
//   stores: words two, counts four to a 16-byte store, the four flags
//   (count >= min_count) in one 4-byte store, scalar stores for a head and
//   tail off the 16-byte boundary. Two groups take alternate tiles, so one
//   group's look-back waits while the other stores. The look-back is on no
//   consumer's path: a tile's place is only needed to store it.
//   run_counts: consumer warp w takes positions w * 256 .. + 255 of the
//   tile, lane l the positions i * 32 + l (i < 8): every shared load of a
//   warp reads 32 consecutive words, free of bank conflicts. A start is a
//   word unlike the one before it (both from the stage; the 2 words before
//   the tile come with it); the warps' ballots number the starts in
//   position order. With unit weights (the build's call) a consumer stages
//   each start's position, and the storers take a run's count as the
//   distance to the next start, up to cap: no run is walked. The tile's
//   last run, which may go on past the tile, is counted by its starter
//   from a halo of 32 positions copied with the tile, then from global
//   memory (the block's next tile is some 132 tickets on, not the next
//   positions, so the ring cannot hold a continuation). With weights, each
//   starter sums its run the same way, up to cap.
//   merge_counts: a partition kernel finds each tile's split of A and B on
//   the merge path (diagonals 4096 apart; a warp a diagonal, 32 probes a
//   step, so a search takes log32 of the range's round trips) and moves the
//   split one pair on where it would part a word of both runs (A's copy the
//   last of a tile, B's the first of the next): no equal pair crosses a tile
//   edge, a tile's distinct count is its own, and the look-back carries no
//   word. It also zeroes the look-back words, so a merge is two launches and
//   no memset. The producer reads each tile's split a tile ahead and copies
//   the 16-byte chunks that hold its pieces of A and B (a few neighbours
//   come along; plain loads for those in an array's last, partial chunk).
//   Each consumer thread finds the merge path at 8 outputs apart in shared
//   memory and merges its 8 serially, the next two words and counts of
//   each piece in registers; a word of both runs, A's copy first, takes B's
//   count too there, saturating at cap.
//   num is written by the last tile's storers; the kept count is summed by
//   each storer warp over its tiles, and the last storer warp of the grid
//   writes it (a done counter): stats needs no memset. run_counts keeps one
//   memset a call, of its look-back words (8 bytes a tile): they must read
//   "not published" before any block starts, and scratch kept zeroed
//   between calls would tie every stream and thread of the process to one
//   buffer. An input not on a 16-byte boundary, and run_counts' partial last
//   tile, are loaded by the consumers with plain loads (a scalar tile); an
//   output off the boundary is stored in scalar stores.
//   What held each step back, from per-role clock64() sums over a tile (a
//   patched copy; Nsight Compute does not run on the measuring machine):
//   one block of 16 warps an SM runs latency-bound code; a single-thread
//   producer with three global round trips a tile starved the consumers
//   (tickets and splits are now claimed ahead); a look-back by the
//   consumers stalled all 16 warps a tile, and a deep ring held claimed
//   tiles back from publishing their counts, so every later tile's
//   look-back waited (two input stages now, storers apart); walking each
//   run with dependent shared loads cost the consumers 1.3 us of a 3.5 us
//   tile (now the storers' subtraction).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = kConsumerWarps * 32;      // 512 threads: count or merge a tile
constexpr int kStorerWarps = 4;
constexpr int kStorers = kStorerWarps * 32;          // 128 threads: look back, store
constexpr int kGroups = 2;                           // storer groups, alternate tiles
constexpr int kGroupThreads = kStorers / kGroups;
constexpr int kProducerWarp = kConsumerWarps + kStorerWarps;
constexpr int kThreads = kConsumers + kStorers + 32;   // and the producer warp: 672
constexpr int kIpt = 8;                              // positions a consumer thread
constexpr int kTile = kConsumers * kIpt;             // positions a tile: 4096
constexpr int kInStages = 2;   // the input ring: one tile counted while the next loads
constexpr int kHalo = 32;      // run_counts: positions past a tile copied with it
constexpr int kLookRows = 8;   // look-back: 32 tiles a row, up to 256 a step
// An input stage: words (run_counts: the 2 before the tile, the tile and
// its halo; merge_counts: the tile's pieces of A and B, each from a
// 16-byte boundary to one: up to kTile + 1 pairs and 4 pads) and counts (4
// before, the tile, the halo). An output buffer (one a storer group): the
// tile's distinct words and their counts (run_counts with unit weights:
// their starts' positions).
constexpr int kInWords = kTile + 2 + kHalo + 6;
constexpr int kInCounts = kTile + 4 + kHalo + 4;
constexpr int kInCountsOffset = kInWords * 8;
constexpr int kInBytes = kInCountsOffset + kInCounts * 4;
constexpr int kOutWords = kTile + 8, kOutCounts = kTile + 16;
constexpr int kOutCountsOffset = kOutWords * 8;
constexpr int kOutBytes = kOutCountsOffset + kOutCounts * 4;
constexpr int kSmemBytes = kInStages * kInBytes + kGroups * kOutBytes;
static_assert(kInCountsOffset % 16 == 0 && kInBytes % 16 == 0 && kOutBytes % 16 == 0,
              "bulk copies need 16-byte aligned stages");
static_assert(kInWords >= kTile + 8 && kInCounts >= kTile + 16, "a merge tile's pieces");
constexpr unsigned kFull = 0xffffffffu;
// Look-back word: bit 62 an aggregate, bit 63 an inclusive prefix, the
// low 62 bits the count; 0 is "not published yet".
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;
constexpr unsigned long long kValue = kAggregate - 1;
// Scratch (uint64): the look-back words [tiles], then the ticket, the done
// counter and the kept total.
constexpr int kScratchTail = 3;

// --- mbarriers and bulk copies ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Generic-proxy accesses of shared memory before, async-proxy (bulk copy)
// accesses after.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Named barriers: 1 for the consumers, 2 + g for storer group g.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(2 + g), "n"(kGroupThreads) : "memory");
}

__device__ __forceinline__ int64_t* in_words(unsigned char* smem, int s) {
  return reinterpret_cast<int64_t*>(smem + s * kInBytes);
}
__device__ __forceinline__ int32_t* in_counts(unsigned char* smem, int s) {
  return reinterpret_cast<int32_t*>(smem + s * kInBytes + kInCountsOffset);
}
__device__ __forceinline__ int64_t* out_words(unsigned char* smem, int g) {
  return reinterpret_cast<int64_t*>(smem + kInStages * kInBytes + g * kOutBytes);
}
__device__ __forceinline__ int32_t* out_counts(unsigned char* smem, int g) {
  return reinterpret_cast<int32_t*>(smem + kInStages * kInBytes + g * kOutBytes +
                                    kOutCountsOffset);
}

// --- the parts both kernels share ---------------------------------------------------

// An input stage's life: the producer fills it ("full"), the consumers
// count or merge it ("empty"). An output buffer's: the consumers stage a
// tile's outputs in it ("staged"), its storer group looks back and stores
// them ("free"). Tile it goes to group it % kGroups.
struct Shared {
  uint64_t full[kInStages], empty[kInStages], staged[kGroups], free[kGroups];
  int64_t tile[kInStages];
  int64_t a0[kInStages], b0[kInStages];    // merge_counts: the tile's split
  int32_t la[kInStages], lb[kInStages];    // merge_counts: its pieces' lengths
  int32_t halo[kInStages];                 // run_counts: positions copied past the tile
  int64_t out_tile[kGroups];
  uint32_t total[kGroups];                 // the tile's distinct words
  unsigned long long before[kGroups];      // distinct words of the tiles before
  uint32_t wsum[kConsumerWarps];
  uint32_t last_count[kGroups];            // run_counts: the count of the tile's last run
};

__device__ __forceinline__ void init_barriers(Shared& sh) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kInStages; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], 1);
    }
    for (int g = 0; g < kGroups; ++g) {
      mbar_init(&sh.staged[g], 1);
      mbar_init(&sh.free[g], kStorerWarps / kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

// The consumers' exclusive scan of one count a thread, in thread order: one
// consumer barrier, then each warp scans the warps' totals itself.
__device__ __forceinline__ uint32_t block_exclusive(Shared& sh, uint32_t mine, int lane, int warp,
                                                    uint32_t& total) {
  const uint32_t inc = warp_inclusive_scan(mine, lane);
  if (lane == 31) sh.wsum[warp] = inc;
  consumer_sync();
  const uint32_t sums = warp_inclusive_scan(lane < kConsumerWarps ? sh.wsum[lane] : 0u, lane);
  total = __shfl_sync(kFull, sums, kConsumerWarps - 1);
  const uint32_t before = __shfl_sync(kFull, sums, warp ? warp - 1 : 0);
  return inc - mine + (warp ? before : 0u);
}

// The tile's count of distinct words, published for the look-back as soon
// as the block scan has it (tile 0's is its inclusive prefix): an atomic
// add into the zeroed word, which the thread does not wait on.
__device__ __forceinline__ void publish_count(int64_t tile, uint32_t total,
                                              unsigned long long* lookback, int ct) {
  if (ct == 0) atomicAdd(lookback + tile, (tile ? kAggregate : kPrefix) | total);
}

// A consumer's wait for tile it's output buffer, before its staging writes.
__device__ __forceinline__ void wait_out(Shared& sh, uint32_t it) {
  mbar_wait(&sh.free[it % kGroups], ((it / kGroups) & 1) ^ 1);
}

// A consumer's end of a tile, after its staging writes: the output buffer
// handed to its storer group and the input stage back to the producer (all
// its reads are done: the barrier).
__device__ __forceinline__ void tile_done(Shared& sh, uint32_t it, int s, int64_t tile,
                                          uint32_t total, int ct) {
  consumer_sync();
  if (ct == 0) {
    const int g = it % kGroups;
    sh.out_tile[g] = tile;
    sh.total[g] = total;
    mbar_arrive(&sh.staged[g]);
    mbar_arrive(&sh.empty[s]);
  }
}

// A consumer's tile past the last: the input stage back, and (once its
// output buffer is free) a stop for the storer group the tile would go to.
__device__ __forceinline__ void tile_stop(Shared& sh, uint32_t it, int s, int64_t tile, int ct) {
  if (ct == 0) {
    wait_out(sh, it);
    sh.out_tile[it % kGroups] = tile;
    mbar_arrive(&sh.staged[it % kGroups]);
    mbar_arrive(&sh.empty[s]);
  }
}

// The distinct words of tiles 0 .. tile - 1, by one warp: the published
// counts from tile - 1 down to the nearest inclusive prefix (the block's own
// previous tile, some grid-size tiles back, has one), 32 tiles a row, lane l
// the l-th nearest of its row. All rows of a step are loaded at once; a
// row waits for its counts only if no nearer row holds a prefix.
__device__ unsigned long long walk_back(const unsigned long long* lookback, int64_t tile,
                                        int lane) {
  unsigned long long before = 0;
  for (int64_t top = tile - 1;; top -= 32 * kLookRows) {
    unsigned long long v[kLookRows];
#pragma unroll
    for (int r = 0; r < kLookRows; ++r) {
      const int64_t q = top - (r * 32 + lane);
      v[r] = q >= 0 ? *(volatile const unsigned long long*)(lookback + q) : kPrefix;
    }
#pragma unroll
    for (int r = 0; r < kLookRows; ++r) {
      const int64_t q = top - (r * 32 + lane);
      while (v[r] == 0) v[r] = *(volatile const unsigned long long*)(lookback + q);
      const unsigned prefixes = __ballot_sync(kFull, (v[r] & kPrefix) != 0);
      const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
      unsigned long long val = lane <= stop ? (v[r] & kValue) : 0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) val += __shfl_down_sync(kFull, val, o);
      before += __shfl_sync(kFull, val, 0);
      if (prefixes) return before;
    }
  }
}

// A staged run's count: staged as it is, or (``positions``: run_counts
// with unit weights) the distance from its start to the next run's, up to
// cap; the tile's last run's is ``last``.
struct StagedCounts {
  const int32_t* sc;
  uint32_t total, last, cap;
  bool positions;
  __device__ __forceinline__ int32_t operator()(uint32_t r) const {
    if (!positions) return sc[r];
    if (r + 1 == total) return (int32_t)last;
    const uint32_t d = (uint32_t)(sc[r + 1] - sc[r]);
    return (int32_t)(d < cap ? d : cap);
  }
};

// The tile's staged outputs 0 .. total - 1 to first .. first + total - 1:
// words 2 a 16-byte store, counts 4 a 16-byte store with their 4 flags
// (count >= min_count) in one 4-byte store, and scalar stores for a head up
// to the boundary and for a tail; all scalar where an output is
// misaligned. Returns how many flags are set.
__device__ uint32_t store_runs(const int64_t* sw, const StagedCounts& count, uint32_t total,
                               int64_t first, int64_t* wo, int32_t* co, uint8_t* so,
                               uint32_t min_count, int st, bool aligned) {
  uint32_t kept = 0;
  const auto one = [&](uint32_t r) {
    const int32_t c = count(r);
    co[first + r] = c;
    if (so) {
      so[first + r] = (uint32_t)c >= min_count;
      kept += (uint32_t)c >= min_count;
    }
  };
  if (!aligned) {
    for (uint32_t j = st; j < total; j += kGroupThreads) {
      wo[first + j] = sw[j];
      one(j);
    }
    return kept;
  }
  const uint32_t hw = (uint32_t)(first & 1) < total ? (uint32_t)(first & 1) : total;
  if ((uint32_t)st < hw) wo[first + st] = sw[st];
  const uint32_t nw = (total - hw) / 2;
  for (uint32_t k = st; k < nw; k += kGroupThreads) {
    const uint32_t j = hw + 2 * k;
    *reinterpret_cast<longlong2*>(wo + first + j) = make_longlong2(sw[j], sw[j + 1]);
  }
  if (((total - hw) & 1) && st == 0) wo[first + total - 1] = sw[total - 1];
  const uint32_t h4 = (uint32_t)((4 - (first & 3)) & 3);
  const uint32_t hc = h4 < total ? h4 : total;
  if ((uint32_t)st < hc) one(st);
  const uint32_t nc = (total - hc) / 4;
  for (uint32_t k = st; k < nc; k += kGroupThreads) {
    const uint32_t j = hc + 4 * k;
    const int4 c = make_int4(count(j), count(j + 1), count(j + 2), count(j + 3));
    *reinterpret_cast<int4*>(co + first + j) = c;
    if (so) {
      const uint32_t f0 = (uint32_t)c.x >= min_count, f1 = (uint32_t)c.y >= min_count,
                     f2 = (uint32_t)c.z >= min_count, f3 = (uint32_t)c.w >= min_count;
      *reinterpret_cast<uint32_t*>(so + first + j) = f0 | f1 << 8 | f2 << 16 | f3 << 24;
      kept += f0 + f1 + f2 + f3;
    }
  }
  const uint32_t rc = (total - hc) & 3;
  if ((uint32_t)st < rc) one(total - rc + st);
  return kept;
}

// The storers, in groups that take alternate tiles (one group's look-back
// waits while the other stores): each staged tile's place from the
// look-back (its inclusive prefix published, num from the last tile), its
// outputs stored with their counts and flags, the output buffer freed.
// After the last tile, the kept count into the total; the last storer warp
// of the grid to finish writes it (a done counter).
__device__ void storer_loop(Shared& sh, unsigned char* smem, unsigned long long* lookback,
                            int64_t num_tiles, int64_t* stats, int64_t* wo, int32_t* co,
                            uint8_t* so, uint32_t cap, uint32_t min_count, bool positions,
                            bool out_aligned) {
  const int g = (threadIdx.x - kConsumers) / kGroupThreads;
  const int st = (threadIdx.x - kConsumers) % kGroupThreads, lane = st & 31;
  uint32_t kept = 0;
  for (uint32_t use = 0;; ++use) {
    mbar_wait(&sh.staged[g], use & 1);
    const int64_t tile = sh.out_tile[g];
    if (tile >= num_tiles) break;
    const uint32_t total = sh.total[g];
    if (st < 32) {
      const unsigned long long before = tile ? walk_back(lookback, tile, lane) : 0ull;
      if (lane == 0) {
        // The aggregate becomes the inclusive prefix: one add.
        if (tile) atomicAdd(lookback + tile, kPrefix - kAggregate + before);
        sh.before[g] = before;
        if (tile == num_tiles - 1) stats[0] = (int64_t)(before + total);
      }
    }
    group_sync(g);
    const StagedCounts count{out_counts(smem, g), total, sh.last_count[g], cap, positions};
    kept += store_runs(out_words(smem, g), count, total, (int64_t)sh.before[g], wo, co, so,
                       min_count, st, out_aligned);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.free[g]);
  }
  unsigned long long* tail = lookback + num_tiles;
  kept = __reduce_add_sync(kFull, kept);
  if (lane == 0) {
    if (kept) atomicAdd(tail + 2, (unsigned long long)kept);
    __threadfence();
    if (atomicAdd(reinterpret_cast<unsigned int*>(tail + 1), 1u) ==
        gridDim.x * kStorerWarps - 1) {
      __threadfence();
      stats[1] = so ? (int64_t)atomicAdd(tail + 2, 0ull) : 0;
    }
  }
}

// The producer's ticket, claimed one tile ahead: the atomic's round trip
// overlaps a tile.
struct Tickets {
  unsigned int* counter;
  int64_t next;
  __device__ __forceinline__ explicit Tickets(unsigned long long* tail)
      : counter(reinterpret_cast<unsigned int*>(tail)), next(atomicAdd(counter, 1u)) {}
  __device__ __forceinline__ int64_t take(int64_t num_tiles) {
    const int64_t tile = next;
    if (tile < num_tiles) next = atomicAdd(counter, 1u);
    return tile;
  }
};

// --- run_counts -----------------------------------------------------------------------

// The count of the tile's last run, which starts at tile position j and
// goes on to the tile's end, then perhaps through the halo's words and
// global memory's, up to cap.
__device__ uint32_t run_tail(const int64_t* W, const int64_t* words, int j, int len, int reach,
                             int64_t base, int64_t n, int64_t x, uint32_t cap) {
  uint64_t sum = (uint64_t)(len - j);
  int q = len;
  while (sum < cap && q < reach && W[q] == x) ++sum, ++q;
  if (q == reach)
    for (int64_t g = base + reach; sum < cap && g < n && words[g] == x; ++g) ++sum;
  return sum < cap ? (uint32_t)sum : cap;
}

__global__ void __launch_bounds__(kThreads, 1)
run_counts_kernel(const int64_t* __restrict__ words, const int32_t* __restrict__ weights,
                  int64_t* __restrict__ words_out, int32_t* __restrict__ counts_out,
                  uint8_t* __restrict__ selected, int64_t* __restrict__ stats,
                  unsigned long long* __restrict__ scratch, int64_t n, int64_t num_tiles,
                  uint32_t cap, uint32_t min_count, int bulk, int out_aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Shared sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* tail = scratch + num_tiles;
  init_barriers(sh);

  if (warp == kProducerWarp) {
    if (lane != 0) return;
    Tickets tickets(tail);
    int stops = 0;
    for (uint32_t it = 0;; ++it) {
      const int s = it % kInStages;
      mbar_wait(&sh.empty[s], ((it / kInStages) & 1) ^ 1);
      const int64_t tile = tickets.take(num_tiles);
      sh.tile[s] = tile;
      if (tile >= num_tiles) {
        // One past the tiles for each storer group, then stop.
        mbar_arrive(&sh.full[s]);
        if (++stops == kGroups) return;
        continue;
      }
      const int64_t base = tile * kTile;
      if (bulk && base + kTile <= n) {
        // The 2 words (4 weights) before the tile, the tile, and a halo of
        // up to kHalo positions after it.
        int64_t halo = n - base - kTile;
        halo = halo < kHalo ? halo & ~3ll : kHalo;
        sh.halo[s] = (int32_t)halo;
        const int64_t w0 = tile ? base - 2 : base, c0 = tile ? base - 4 : base;
        const uint32_t wb = (uint32_t)(base + kTile + halo - w0) * 8;
        const uint32_t cb = weights ? (uint32_t)(base + kTile + halo - c0) * 4 : 0u;
        fence_proxy_async();
        mbar_arrive_tx(&sh.full[s], wb + cb);
        bulk_load(in_words(smem, s) + (w0 - base + 2), words + w0, wb, &sh.full[s]);
        if (weights)
          bulk_load(in_counts(smem, s) + (c0 - base + 4), weights + c0, cb, &sh.full[s]);
      } else {
        sh.halo[s] = 0;
        mbar_arrive(&sh.full[s]);       // the consumers load a scalar tile
      }
    }
  }
  if (warp >= kConsumerWarps) {
    storer_loop(sh, smem, scratch, num_tiles, stats, words_out, counts_out,
                min_count ? selected : nullptr, cap, min_count, weights == nullptr, out_aligned);
    return;
  }

  const int ct = t;
  const uint32_t lt = (1u << lane) - 1;
  int stops = 0;
  for (uint32_t it = 0;; ++it) {
    const int s = it % kInStages;
    mbar_wait(&sh.full[s], (it / kInStages) & 1);
    const int64_t tile = sh.tile[s];
    if (tile >= num_tiles) {
      tile_stop(sh, it, s, tile, ct);
      if (++stops == kGroups) break;
      continue;
    }
    int64_t* sw = in_words(smem, s);
    int32_t* sc = in_counts(smem, s);
    // The tile's position j: W[j], C[j]; W[-1] the word before it.
    const int64_t* W = sw + 2;
    const int32_t* C = sc + 4;
    const int64_t base = tile * kTile;
    const int len = (int)(n - base < kTile ? n - base : kTile);
    const int halo = sh.halo[s];
    if (!(bulk && base + kTile <= n)) {
      for (int j = ct - (tile ? 1 : 0); j < len; j += kConsumers) {
        sw[2 + j] = words[base + j];
        if (weights) sc[4 + j] = weights[base + j];
      }
      fence_proxy_async();
      consumer_sync();
    }
    // Lane l of warp w: positions w * 256 + i * 32 + l; the word before
    // each from the stage too (W[-1] is the one before the tile).
    const int w0 = warp * (32 * kIpt);
    const int reach = len + halo;       // positions staged from the tile's start
    int64_t x[kIpt];
    uint32_t ballots[kIpt], counts[kIpt], warp_total = 0;
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      const int j = w0 + i * 32 + lane;
      x[i] = j < len ? W[j] : 0;
      const bool start = j < len && (base + j == 0 || x[i] != W[j - 1]);
      ballots[i] = __ballot_sync(kFull, start);
      warp_total += __popc(ballots[i]);
      counts[i] = 0;
      if (weights && start) {
        // The run's weights, from the stage (the tile and its halo) and
        // then from global memory, up to cap.
        uint64_t sum = (uint32_t)C[j];
        int q = j + 1;
        while (sum < cap && q < reach && W[q] == x[i]) sum += (uint32_t)C[q++];
        if (q == reach) {
          for (int64_t g = base + reach; sum < cap && g < n && words[g] == x[i]; ++g)
            sum += (uint32_t)weights[g];
        }
        counts[i] = sum < cap ? (uint32_t)sum : cap;
      }
    }
    uint32_t total;
    uint32_t run = block_exclusive(sh, lane == 0 ? warp_total : 0u, lane, warp, total);
    run = __shfl_sync(kFull, run, 0);
    publish_count(tile, total, scratch, ct);
    // Stage the tile's runs at their numbers in the tile: the word, and its
    // count (weights) or its start's position (unit weights: the storers
    // take the distance to the next start, up to cap). The tile's last run,
    // which may go on past the tile, is counted here.
    wait_out(sh, it);
    const int g = it % kGroups;
    int64_t* ow = out_words(smem, g);
    int32_t* oc = out_counts(smem, g);
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      if (ballots[i] >> lane & 1u) {
        const int j = w0 + i * 32 + lane;
        const uint32_t r = run + __popc(ballots[i] & lt);
        ow[r] = x[i];
        oc[r] = weights ? (int32_t)counts[i] : j;
        if (!weights && r + 1 == total)
          sh.last_count[g] = run_tail(W, words, j, len, reach, base, n, x[i], cap);
      }
      run += __popc(ballots[i]);
    }
    tile_done(sh, it, s, tile, total, ct);
  }
}

// --- merge_counts ---------------------------------------------------------------------

// The number of run A's pairs among the first d of the merge (run A's pair
// first on equal words): the merge path's crossing of diagonal d, over the
// pieces in shared memory.
__device__ __forceinline__ int merge_path_shared(const int64_t* a, int na, const int64_t* b,
                                                 int nb, int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Tile i's split (part[i] pairs of A, part[tiles + 1 + i] of B) at
// diagonal i * kTile, moved one pair of B on where it would part a word of
// both runs; and the look-back words and counters zeroed.
__global__ void merge_partition_kernel(const int64_t* __restrict__ wa, int64_t na,
                                       const int64_t* __restrict__ wb, int64_t nb,
                                       int64_t* __restrict__ part,
                                       unsigned long long* __restrict__ scratch,
                                       int64_t num_tiles) {
  // A warp a diagonal: the answer is the first i in [lo, hi) with
  // wa[i] > wb[d - 1 - i], or hi. Each step cuts the range into 32 parts of
  // ``step`` and probes each part's last index (one at or past hi counts as
  // above): the first part whose probe is above holds the answer. A search
  // takes log32 of the range's steps of one round trip each, not log2.
  const int lane = threadIdx.x & 31;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i > num_tiles) return;
  const int64_t d = i * kTile < na + nb ? i * kTile : na + nb;
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t q = lo + (lane + 1) * step - 1;
    const unsigned above = __ballot_sync(kFull, q >= hi || wa[q] > wb[d - 1 - q]);
    if (!above) {
      lo = hi;
      break;
    }
    const int f = __ffs(above) - 1;
    const int64_t top = lo + (f + 1) * step - 1;
    lo += f * step;
    hi = top < hi ? top : hi;
  }
  if (lane == 0) {
    const int64_t a = lo;
    int64_t b = d - a;
    if (a > 0 && b < nb && wa[a - 1] == wb[b]) ++b;
    part[i] = a;
    part[num_tiles + 1 + i] = b;
    scratch[i] = 0;
    if (i == num_tiles)
      for (int j = 1; j < kScratchTail; ++j) scratch[i + j] = 0;
  }
}

// Where a tile's pieces lie in its stage: A's words from index a0 & 1, B's
// after them from an even index plus b0 & 1 (a word's index is as even as
// its place in memory, so the pieces' 16-byte chunks land on 16-byte
// boundaries); the counts likewise modulo 4.
struct Pieces {
  int oaw, obw, oac, obc;
  __device__ __forceinline__ Pieces(int64_t a0, int64_t b0, int la) {
    oaw = (int)(a0 & 1);
    obw = ((oaw + la + 1) & ~1) + (int)(b0 & 1);
    oac = (int)(a0 & 3);
    obc = ((oac + la + 3) & ~3) + (int)(b0 & 3);
  }
};

// Elements [lo, hi) of src [size] (global) into dst (shared, element e at
// dst[e - lo]): one bulk copy of the 16-byte chunks that hold them (a few
// neighbours come along), and plain loads of those in the array's last,
// partial chunk, which a copy would read past its end. ``bulk`` false:
// only the plain loads, and the bulk bytes; true: only the bulk copy.
template <typename T>
__device__ __forceinline__ uint32_t load_piece(T* dst, const T* src, int64_t size, int64_t lo,
                                               int64_t hi, uint64_t* bar, bool bulk) {
  constexpr int64_t per = 16 / sizeof(T);
  if (lo >= hi) return 0;
  const int64_t clo = lo / per * per, end = size / per * per;
  const int64_t chi = (hi + per - 1) / per * per < end ? (hi + per - 1) / per * per : end;
  if (!bulk)
    for (int64_t e = chi > lo ? chi : lo; e < hi; ++e) dst[e - lo] = src[e];
  if (clo >= chi) return 0;
  if (bulk) bulk_load(dst + (clo - lo), src + clo, (uint32_t)((chi - clo) * sizeof(T)), bar);
  return (uint32_t)((chi - clo) * sizeof(T));
}

__global__ void __launch_bounds__(kThreads, 1)
merge_counts_kernel(const int64_t* __restrict__ wa, const int32_t* __restrict__ ca, int64_t na,
                    const int64_t* __restrict__ wb, const int32_t* __restrict__ cb, int64_t nb,
                    const int64_t* __restrict__ part, int64_t* __restrict__ words_out,
                    int32_t* __restrict__ counts_out, uint8_t* __restrict__ selected,
                    int64_t* __restrict__ stats, unsigned long long* __restrict__ scratch,
                    int64_t num_tiles, uint32_t cap, uint32_t min_count, int bulk,
                    int out_aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Shared sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* tail = scratch + num_tiles;
  const int64_t* part_b = part + num_tiles + 1;
  init_barriers(sh);

  if (warp == kProducerWarp) {
    if (lane != 0) return;
    // Tickets two tiles ahead, and the splits one tile ahead, so that
    // neither round trip stands in a tile's way.
    Tickets tickets(tail);
    int64_t next = tickets.take(num_tiles), split[4] = {0, 0, 0, 0};
    if (next < num_tiles)
      split[0] = part[next], split[1] = part[next + 1], split[2] = part_b[next],
      split[3] = part_b[next + 1];
    int stops = 0;
    for (uint32_t it = 0;; ++it) {
      const int s = it % kInStages;
      mbar_wait(&sh.empty[s], ((it / kInStages) & 1) ^ 1);
      const int64_t tile = next;
      const int64_t a0 = split[0], a1 = split[1], b0 = split[2], b1 = split[3];
      sh.tile[s] = tile;
      if (tile >= num_tiles) {
        // One past the tiles for each storer group, then stop.
        mbar_arrive(&sh.full[s]);
        if (++stops == kGroups) return;
        continue;
      }
      next = tickets.take(num_tiles);
      if (next < num_tiles)
        split[0] = part[next], split[1] = part[next + 1], split[2] = part_b[next],
        split[3] = part_b[next + 1];
      sh.a0[s] = a0;
      sh.b0[s] = b0;
      sh.la[s] = (int)(a1 - a0);
      sh.lb[s] = (int)(b1 - b0);
      if (!bulk) {
        mbar_arrive(&sh.full[s]);       // the consumers load a scalar tile
        continue;
      }
      const Pieces p(a0, b0, (int)(a1 - a0));
      int64_t* sw = in_words(smem, s);
      int32_t* sc = in_counts(smem, s);
      // The plain loads first (stores released by the arrive), then the
      // bulk copies.
      const uint32_t bytes = load_piece(sw + p.oaw, wa, na, a0, a1, &sh.full[s], false) +
                             load_piece(sc + p.oac, ca, na, a0, a1, &sh.full[s], false) +
                             load_piece(sw + p.obw, wb, nb, b0, b1, &sh.full[s], false) +
                             load_piece(sc + p.obc, cb, nb, b0, b1, &sh.full[s], false);
      fence_proxy_async();
      mbar_arrive_tx(&sh.full[s], bytes);
      load_piece(sw + p.oaw, wa, na, a0, a1, &sh.full[s], true);
      load_piece(sc + p.oac, ca, na, a0, a1, &sh.full[s], true);
      load_piece(sw + p.obw, wb, nb, b0, b1, &sh.full[s], true);
      load_piece(sc + p.obc, cb, nb, b0, b1, &sh.full[s], true);
    }
  }
  if (warp >= kConsumerWarps) {
    storer_loop(sh, smem, scratch, num_tiles, stats, words_out, counts_out,
                min_count ? selected : nullptr, cap, min_count, false, out_aligned);
    return;
  }

  const int ct = t;
  int stops = 0;
  for (uint32_t it = 0;; ++it) {
    const int s = it % kInStages;
    mbar_wait(&sh.full[s], (it / kInStages) & 1);
    const int64_t tile = sh.tile[s];
    if (tile >= num_tiles) {
      tile_stop(sh, it, s, tile, ct);
      if (++stops == kGroups) break;
      continue;
    }
    const int64_t a0 = sh.a0[s], b0 = sh.b0[s];
    const int la = sh.la[s], lb = sh.lb[s], len = la + lb;
    const Pieces p(a0, b0, la);
    int64_t* sw = in_words(smem, s);
    int32_t* sc = in_counts(smem, s);
    if (!bulk) {
      for (int j = ct; j < len; j += kConsumers) {
        if (j < la) {
          sw[p.oaw + j] = wa[a0 + j];
          sc[p.oac + j] = ca[a0 + j];
        } else {
          sw[p.obw + j - la] = wb[b0 + j - la];
          sc[p.obc + j - la] = cb[b0 + j - la];
        }
      }
      fence_proxy_async();
      consumer_sync();
    }
    const int64_t* A = sw + p.oaw;
    const int64_t* B = sw + p.obw;
    const int32_t* CA = sc + p.oac;
    const int32_t* CB = sc + p.obc;
    // This thread's 8 outputs of the merge, from its place on the path.
    const int dt = ct * kIpt < len ? ct * kIpt : len;
    int ia = merge_path_shared(A, la, B, lb, dt), ib = dt - ia;
    bool have_prev = dt > 0;
    int64_t prev = 0;
    if (ia > 0 && ib > 0)
      prev = A[ia - 1] > B[ib - 1] ? A[ia - 1] : B[ib - 1];
    else if (ia > 0)
      prev = A[ia - 1];
    else if (ib > 0)
      prev = B[ib - 1];
    // Both pieces' next two words and counts ride in registers, so a step
    // of the merge waits on no shared load.
    int64_t av = ia < la ? A[ia] : 0, an = ia + 1 < la ? A[ia + 1] : 0;
    int64_t bv = ib < lb ? B[ib] : 0, bn = ib + 1 < lb ? B[ib + 1] : 0;
    uint32_t cav = ia < la ? (uint32_t)CA[ia] : 0u, can = ia + 1 < la ? (uint32_t)CA[ia + 1] : 0u;
    uint32_t cbv = ib < lb ? (uint32_t)CB[ib] : 0u, cbn = ib + 1 < lb ? (uint32_t)CB[ib + 1] : 0u;
    int64_t w[kIpt];
    uint32_t c[kIpt], flags = 0;
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      w[i] = 0;
      c[i] = 0;
      if (dt + i < len) {
        const bool take_a = ib >= lb || (ia < la && av <= bv);
        const int64_t word = take_a ? av : bv;
        if (!have_prev || word != prev) {
          // A word of both runs: A's copy first, B's right after it.
          const uint64_t sum = take_a ? (uint64_t)cav + (ib < lb && bv == word ? cbv : 0u)
                                      : (uint64_t)cbv;
          w[i] = word;
          c[i] = sum < cap ? (uint32_t)sum : cap;
          flags |= 1u << i;
        }
        prev = word;
        have_prev = true;
        if (take_a) {
          ++ia;
          av = an;
          cav = can;
          an = ia + 1 < la ? A[ia + 1] : 0;
          can = ia + 1 < la ? (uint32_t)CA[ia + 1] : 0u;
        } else {
          ++ib;
          bv = bn;
          cbv = cbn;
          bn = ib + 1 < lb ? B[ib + 1] : 0;
          cbn = ib + 1 < lb ? (uint32_t)CB[ib + 1] : 0u;
        }
      }
    }
    uint32_t total;
    uint32_t run = block_exclusive(sh, __popc(flags), lane, warp, total);
    publish_count(tile, total, scratch, ct);
    wait_out(sh, it);
    int64_t* ow = out_words(smem, it % kGroups);
    int32_t* oc = out_counts(smem, it % kGroups);
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      if (flags >> i & 1u) {
        ow[run] = w[i];
        oc[run] = (int32_t)c[i];
        ++run;
      }
    }
    tile_done(sh, it, s, tile, total, ct);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

cudaError_t persistent_grid(const void* kernel, int64_t tiles, unsigned& grid) {
  if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             kSmemBytes))
    return err;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return err;
  if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return err;
  if (cudaError_t err =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes))
    return err;
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  grid = (unsigned)(tiles < most ? tiles : most);
  return cudaSuccess;
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// uint64 words of scratch run_counts takes for n positions: the look-back
// words and three counters.
extern "C" int64_t kw_run_scratch_words(int64_t n) { return tiles_of(n) + kScratchTail; }

// uint64 words of scratch merge_counts takes: the tiles' splits of A and B
// (2 x (tiles + 1)), the look-back words and three counters.
extern "C" int64_t kw_merge_scratch_words(int64_t na, int64_t nb) {
  const int64_t tiles = tiles_of(na + nb);
  return 2 * (tiles + 1) + tiles + kScratchTail;
}

// counts_out must not alias words_out. weights, selected: may be null
// (selected must not be when min_count > 0 and n > 0). scratch:
// kw_run_scratch_words(n).
extern "C" int kw_run_counts(const void* words, const void* weights, void* words_out,
                             void* counts_out, void* selected, void* stats, void* scratch,
                             int64_t n, int64_t cap, int64_t min_count, void* stream) {
  if (n < 0 || cap < 1 || cap > 0x7fffffff || min_count < 0 || min_count > cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaMemsetAsync(stats, 0, 2 * sizeof(int64_t), s);
  if (min_count > 0 && selected == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(n);
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  if (cudaError_t err = persistent_grid((const void*)run_counts_kernel, tiles, grid))
    return (int)err;
  if (cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(tiles + kScratchTail) * 8, s))
    return (int)err;
  const int bulk = aligned16(words) && (weights == nullptr || aligned16(weights));
  const int out_aligned = aligned16(words_out) && aligned16(counts_out) &&
                          (min_count == 0 || aligned16(selected));
  run_counts_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      (const int64_t*)words, (const int32_t*)weights, (int64_t*)words_out, (int32_t*)counts_out,
      (uint8_t*)selected, (int64_t*)stats, (unsigned long long*)scratch, n, tiles,
      (uint32_t)cap, (uint32_t)min_count, bulk, out_aligned);
  return (int)cudaGetLastError();
}

// words_out / counts_out (/ selected) hold na + nb entries. scratch:
// kw_merge_scratch_words(na, nb).
extern "C" int kw_merge_counts(const void* words_a, const void* counts_a, const void* words_b,
                               const void* counts_b, void* words_out, void* counts_out,
                               void* selected, void* stats, void* scratch, int64_t na,
                               int64_t nb, int64_t cap, int64_t min_count, void* stream) {
  if (na < 0 || nb < 0 || cap < 1 || cap > 0x7fffffff || min_count < 0 || min_count > cap)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = na + nb;
  if (n == 0) return (int)cudaMemsetAsync(stats, 0, 2 * sizeof(int64_t), s);
  if (min_count > 0 && selected == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(n);
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  if (cudaError_t err = persistent_grid((const void*)merge_counts_kernel, tiles, grid))
    return (int)err;
  int64_t* part = (int64_t*)scratch;
  unsigned long long* lookback = (unsigned long long*)(part + 2 * (tiles + 1));
  merge_partition_kernel<<<(unsigned)((tiles + 8) / 8), 256, 0, s>>>(
      (const int64_t*)words_a, na, (const int64_t*)words_b, nb, part, lookback, tiles);
  const int bulk = aligned16(words_a) && aligned16(counts_a) && aligned16(words_b) &&
                   aligned16(counts_b);
  const int out_aligned = aligned16(words_out) && aligned16(counts_out) &&
                          (min_count == 0 || aligned16(selected));
  merge_counts_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      (const int64_t*)words_a, (const int32_t*)counts_a, na, (const int64_t*)words_b,
      (const int32_t*)counts_b, nb, part, (int64_t*)words_out, (int32_t*)counts_out,
      (uint8_t*)selected, (int64_t*)stats, lookback, tiles, (uint32_t)cap, (uint32_t)min_count,
      bulk, out_aligned);
  return (int)cudaGetLastError();
}
