// radix_sort_pairs: the ingest's sort of (accession, word) windows.
//
// Replaces: kwage_tpu/ops/counting.py _sort_words and the accession key of
// _count_multi_core (jax.lax.sort, which XLA compiled on the TPU).
//
// Inputs: acc int64 [n], words int64 [n]. Output: the pairs ordered by
// (acc, word), both compared as signed int64; with a limit, only the pairs
// with 0 <= acc < limit (the valid windows), in the same order. Equal pairs
// cannot be told apart, so the output is one fixed array of bits; every
// pass is stable all the same, because an LSD radix sort is only right when
// each pass keeps the order the earlier passes made.
//
// The key. A pair is the integer acc:word of word_bits + acc_bits bits
// (word_bits = 2k, or 64; acc_bits = the bits an accession can fill, 0 when
// there is one accession). The caller's plan cuts it into digits from bit 0
// up: 8 bits each, and a top digit of up to 10 bits where that saves a pass
// (k = 31 with up to 16 accessions: 62 + 4 bits in 7 digits of 8 and one
// of 10, 8 passes, not 9). A digit may hold the word's top bits and the
// accession's low bits together. A 64-bit word or accession is kept with
// its sign bit flipped from the first pass's load to the last pass's store,
// so that unsigned digits order it as signed.
//
// Bound: bytes. The function reads both arrays once (the words of dropped
// windows need not be read) and writes the kept pairs once.
//
// Design: the one-sweep LSD radix sort of Adinets and Merrill ("Onesweep",
// 2022), for Hopper:
//   1. radix_sort_hist (entry kw_radix_sort_hist): ONE read of the input
//      counts the digits of every pass at once, over the kept pairs only
//      (shared-memory histograms, one global add a bin and block); a second
//      small kernel turns each pass's counts into its digits' first output
//      positions and writes the number of kept pairs (the caller's one copy
//      to the host, when it drops windows).
//   2. radix_sort_pass (entry kw_radix_sort_pairs): one kernel a pass. A
//      block takes the next tile of 4096 pairs from an atomic counter (so a
//      tile only ever waits on tiles whose blocks already run), loads 8
//      pairs a thread of 512 (63 registers: two blocks, 32 warps an SM),
//      and ranks them stably: a warp owns 256 consecutive pairs and takes
//      them 32 at a time in order; __match_any_sync finds the lanes of the
//      same digit (6% faster than one __ballot_sync a digit bit, and 256
//      threads of 16 pairs were 17% slower: 128 registers, 16 warps an SM),
//      the highest of them bumps the warp's counter for that digit in
//      shared memory; warps are prefixed in warp order. The tile publishes each digit's count, then looks back
//      over the tiles before it (decoupled look-back: an aggregate, or an
//      inclusive prefix that ends the walk) for the digit's pairs in earlier
//      tiles, and publishes its own inclusive prefix. The first pass drops
//      the windows outside [0, limit). The pairs are staged in shared memory
//      in digit order, then each digit's run leaves from consecutive
//      threads to consecutive addresses, so the stores fill whole sectors.
//   3. The accession rides between passes as uint8 or uint16 (as int64 only
//      when it needs more than 16 bits), and not at all for one accession:
//      the last pass widens it to int64, or the caller zero-fills it.
// The look-back words carry the pass in their top bits, so one zeroing of
// the buffer serves every pass. Pair indices are 32-bit (n < 2^32), widened
// to 64 bits before they scale to bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                   // pairs a thread
constexpr int kTile = kThreads * kItems;    // pairs a block: 4096
constexpr int kPerWarp = 32 * kItems;       // consecutive pairs a warp: 256
constexpr int kMaxPasses = 16;
constexpr int kMaxWidth = 10;
constexpr int kHistThreads = 256;
constexpr int kBaseThreads = 1 << kMaxWidth;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kSign = 1ull << 63;
// Look-back word: bits 0-31 a count, 32-33 its kind, 34.. the pass + 1.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr int kEpochShift = 34;

template <int AB> struct Acc { using type = uint8_t; using reg = uint32_t; };
template <> struct Acc<2> { using type = uint16_t; using reg = uint32_t; };
template <> struct Acc<8> { using type = uint64_t; using reg = uint64_t; };

int acc_bytes_of(int64_t acc_bits) {
  return acc_bits == 0 ? 0 : acc_bits <= 8 ? 1 : acc_bits <= 16 ? 2 : 8;
}

// Bits [shift, shift + width) of the key acc:word. `w` and `a` are the kept
// forms (sign flipped where the plan says); word bits above word_bits and
// accession bits above acc_bits never reach a digit.
__device__ __forceinline__ uint32_t digit_of(uint64_t w, uint64_t a, int shift,
                                             int width, int word_bits) {
  uint64_t v;
  if (shift >= word_bits) {
    v = a >> (shift - word_bits);
  } else {
    const uint64_t lo = word_bits == 64 ? w : w & ((1ull << word_bits) - 1);
    v = lo >> shift;
    const int up = word_bits - shift;
    if (up < 64) v |= a << up;
  }
  return (uint32_t)v & ((1u << width) - 1u);
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

struct Plan {
  int passes, word_bits, acc_bits, total_bins;
  int shift[kMaxPasses], width[kMaxPasses], offset[kMaxPasses];
};

// --- 1. every pass's digit counts in one read ----------------------------------

__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const int64_t* __restrict__ acc, const int64_t* __restrict__ words,
                  int64_t n, uint64_t limit, uint64_t acc_mask, Plan plan,
                  uint32_t* __restrict__ hist) {
  extern __shared__ uint32_t s_hist[];
  for (int j = threadIdx.x; j < plan.total_bins; j += kHistThreads) s_hist[j] = 0;
  __syncthreads();
  const uint64_t wflip = plan.word_bits == 64 ? kSign : 0;
  const uint64_t aflip = plan.acc_bits == 64 ? kSign : 0;
  const bool read_acc = limit != 0 || acc_mask != 0;
  for (int64_t i = (int64_t)blockIdx.x * kHistThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kHistThreads) {
    const uint64_t raw = read_acc ? (uint64_t)acc[i] : 0;
    if (limit != 0 && raw >= limit) continue;
    const uint64_t w = (uint64_t)words[i] ^ wflip;
    const uint64_t a = (raw ^ aflip) & acc_mask;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p < plan.passes)
        atomicAdd(&s_hist[plan.offset[p] +
                          digit_of(w, a, plan.shift[p], plan.width[p], plan.word_bits)], 1u);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < plan.total_bins; j += kHistThreads)
    if (s_hist[j]) atomicAdd(&hist[j], s_hist[j]);
}

// Block p: pass p's digit counts -> the first output position of each digit
// (in place); block 0 also writes the number of counted pairs.
__global__ void __launch_bounds__(kBaseThreads)
radix_base_kernel(uint32_t* __restrict__ hist, Plan plan, int64_t* __restrict__ kept) {
  __shared__ uint32_t s_wsum[kBaseThreads / 32];
  const int p = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int bins = 1 << plan.width[p];
  uint32_t* row = hist + plan.offset[p];
  const uint32_t v = t < bins ? row[t] : 0u;
  const uint32_t inc = warp_inclusive_scan(v, lane);
  if (lane == 31) s_wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) s_wsum[lane] = warp_inclusive_scan(s_wsum[lane], lane);
  __syncthreads();
  const uint32_t before = warp ? s_wsum[warp - 1] : 0u;
  if (t < bins) row[t] = before + inc - v;
  if (p == 0 && t == 0) *kept = (int64_t)s_wsum[kBaseThreads / 32 - 1];
}

// --- 2. one pass ---------------------------------------------------------------------

struct PassArgs {
  const int64_t* acc_in64;     // the first pass: the caller's accessions
  const void* acc_in;          // later passes: the narrow accessions
  const uint64_t* words_in;
  void* acc_out;               // not the last pass: the narrow accessions
  int64_t* acc_out64;          // the last pass: int64 accessions
  uint64_t* words_out;
  int64_t n;                   // pairs this pass reads
  uint64_t limit;              // the first pass keeps 0 <= acc < limit (0: all)
  int shift, width, word_bits, acc_bits;
  const uint32_t* base;        // this pass's digits' first output positions
  unsigned long long* lookback;
  uint32_t* tile_counter;
  unsigned long long epoch;    // (pass + 1) << kEpochShift
};

size_t pass_smem_bytes(int acc_bytes, int width) {
  const size_t bins = (size_t)1 << width;
  return (size_t)kTile * (8 + acc_bytes) + kWarps * bins * 2 + 3 * bins * 4;
}

template <int AB, bool FIRST, bool LAST>
__global__ void __launch_bounds__(kThreads, 2) radix_pass_kernel(PassArgs p) {
  using P = typename Acc<AB>::type;
  using R = typename Acc<AB>::reg;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_wsum[kWarps];
  const int bins = 1 << p.width;
  uint64_t* s_w = reinterpret_cast<uint64_t*>(smem);             // [kTile]
  P* s_a = reinterpret_cast<P*>(s_w + kTile);                    // [kTile] (AB > 0)
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(smem + (size_t)kTile * (8 + AB));
  uint32_t* s_count = reinterpret_cast<uint32_t*>(s_cnt + kWarps * bins);  // [bins]
  uint32_t* s_prefix = s_count + bins;                           // [bins]
  uint32_t* s_gbase = s_prefix + bins;                           // [bins]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(p.tile_counter, 1u);
  for (int j = t; j < kWarps * bins; j += kThreads) s_cnt[j] = 0;
  __syncthreads();
  const uint32_t tile = s_tile;
  const uint64_t wflip = p.word_bits == 64 ? kSign : 0;
  const uint64_t aflip = p.acc_bits == 64 ? kSign : 0;

  // Load: 16 pairs a thread, warp w's 512 consecutive pairs, 32 at a time.
  const int64_t first = (int64_t)tile * kTile + warp * kPerWarp + lane;
  uint64_t w[kItems];
  R a[kItems];
  bool live[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = first + r * 32;
    live[r] = i < p.n;
    w[r] = 0;
    a[r] = 0;
    if (!live[r]) continue;
    if constexpr (FIRST) {
      uint64_t raw = 0;
      if (p.limit != 0 || AB > 0) raw = (uint64_t)p.acc_in64[i];
      if (p.limit != 0 && raw >= p.limit) {
        live[r] = false;
        continue;
      }
      w[r] = p.words_in[i] ^ wflip;
      if constexpr (AB > 0) a[r] = (R)(P)(raw ^ aflip);
    } else {
      w[r] = p.words_in[i];
      if constexpr (AB > 0) a[r] = (R) static_cast<const P*>(p.acc_in)[i];
    }
  }

  // Rank: place = digit << 16 | pairs of that digit before this one in the warp.
  uint32_t place[kItems];
  const unsigned lanes_below = (1u << lane) - 1u;
  uint16_t* my_cnt = s_cnt + warp * bins;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const uint32_t d = live[r] ? digit_of(w[r], (uint64_t)a[r], p.shift, p.width,
                                          p.word_bits) : 0u;
    const unsigned same = __match_any_sync(kFull, live[r] ? d : 0xffffffffu);
    uint32_t before = 0;
    if (live[r]) before = my_cnt[d];
    __syncwarp();
    if (live[r] && lane == 31 - __clz(same))
      my_cnt[d] = (uint16_t)(before + (uint32_t)__popc(same));
    __syncwarp();
    place[r] = live[r] ? (d << 16) | (before + (uint32_t)__popc(same & lanes_below))
                       : 0xffffffffu;
  }
  __syncthreads();

  // Digit d: the tile's count, the warps' exclusive prefixes, published.
  unsigned long long* my_lb = p.lookback + (int64_t)tile * bins;
  for (int d = t; d < bins; d += kThreads) {
    uint32_t run = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const uint32_t c = s_cnt[j * bins + d];
      s_cnt[j * bins + d] = (uint16_t)run;
      run += c;
    }
    s_count[d] = run;
    *(volatile unsigned long long*)(my_lb + d) =
        p.epoch | (tile == 0 ? kPrefix : kAggregate) | run;
  }
  __syncthreads();

  // The tile's exclusive prefix over digits (its staging order).
  {
    const int per = (bins + kThreads - 1) / kThreads;
    const int d0 = t * per;
    uint32_t sum = 0;
    for (int q = 0; q < per; ++q)
      if (d0 + q < bins) sum += s_count[d0 + q];
    const uint32_t inc = warp_inclusive_scan(sum, lane);
    if (lane == 31) s_wsum[warp] = inc;
    __syncthreads();
    uint32_t run = inc - sum;
    for (int j = 0; j < warp; ++j) run += s_wsum[j];
    for (int q = 0; q < per; ++q)
      if (d0 + q < bins) {
        s_prefix[d0 + q] = run;
        run += s_count[d0 + q];
      }
  }

  // Decoupled look-back: digit d's pairs in the tiles before this one.
  for (int d = t; d < bins; d += kThreads) {
    uint32_t excl = 0;
    if (tile > 0) {
      for (int64_t j = (int64_t)tile - 1;; --j) {
        const volatile unsigned long long* q = p.lookback + j * bins + d;
        unsigned long long v;
        do {
          v = *q;
        } while ((v >> kEpochShift) != (p.epoch >> kEpochShift));
        excl += (uint32_t)v;
        if (v & kPrefix) break;
      }
      *(volatile unsigned long long*)(my_lb + d) = p.epoch | kPrefix | (excl + s_count[d]);
    }
    s_gbase[d] = p.base[d] + excl;
  }
  __syncthreads();

  // Stage the tile in digit order, then store each digit's run in one sweep.
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (place[r] == 0xffffffffu) continue;
    const uint32_t d = place[r] >> 16;
    const uint32_t local = s_prefix[d] + s_cnt[warp * bins + d] + (place[r] & 0xffffu);
    s_w[local] = w[r];
    if constexpr (AB > 0) s_a[local] = (P)a[r];
  }
  __syncthreads();
  const uint32_t total = s_prefix[bins - 1] + s_count[bins - 1];
  for (uint32_t j = t; j < total; j += kThreads) {
    const uint64_t wv = s_w[j];
    uint64_t av = 0;
    if constexpr (AB > 0) av = (uint64_t)s_a[j];
    const uint32_t d = digit_of(wv, av, p.shift, p.width, p.word_bits);
    const int64_t pos = (int64_t)s_gbase[d] + (j - s_prefix[d]);
    if constexpr (LAST) {
      p.words_out[pos] = wv ^ wflip;
      if constexpr (AB > 0) p.acc_out64[pos] = (int64_t)(av ^ aflip);
    } else {
      p.words_out[pos] = wv;
      if constexpr (AB > 0) static_cast<P*>(p.acc_out)[pos] = (P)av;
    }
  }
}

template <int AB, bool FIRST, bool LAST>
cudaError_t launch_pass(const PassArgs& args, cudaStream_t s) {
  const size_t smem = pass_smem_bytes(AB, args.width);
  auto kernel = radix_pass_kernel<AB, FIRST, LAST>;
  if (cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return err;
  const int64_t tiles = (args.n + kTile - 1) / kTile;
  kernel<<<(unsigned)tiles, kThreads, smem, s>>>(args);
  return cudaGetLastError();
}

template <int AB>
cudaError_t launch_pass_ab(const PassArgs& args, bool first, bool last, cudaStream_t s) {
  if (first && last) return launch_pass<AB, true, true>(args, s);
  if (first) return launch_pass<AB, true, false>(args, s);
  if (last) return launch_pass<AB, false, true>(args, s);
  return launch_pass<AB, false, false>(args, s);
}

// The caller's plan: `widths` holds pass p's digit width (1..10) in bits
// 4p..4p+3; the digits follow each other from bit 0 and cover the key.
bool make_plan(int64_t word_bits, int64_t acc_bits, int64_t widths, int64_t passes,
               Plan* plan) {
  if (word_bits < 2 || word_bits > 64 || acc_bits < 0 || acc_bits > 64 || passes < 1 ||
      passes > kMaxPasses)
    return false;
  plan->passes = (int)passes;
  plan->word_bits = (int)word_bits;
  plan->acc_bits = (int)acc_bits;
  int shift = 0, offset = 0;
  for (int p = 0; p < kMaxPasses; ++p) {
    const int width = p < passes ? (int)((uint64_t)widths >> (4 * p)) & 15 : 1;
    if (p < passes && (width < 1 || width > kMaxWidth)) return false;
    plan->shift[p] = shift;
    plan->width[p] = width;
    plan->offset[p] = offset;
    if (p < passes) {
      shift += width;
      offset += 1 << width;
    }
  }
  plan->total_bins = offset;
  return shift == word_bits + acc_bits &&
         (passes == kMaxPasses || (uint64_t)widths >> (4 * passes) == 0);
}

uint64_t acc_mask_of(int acc_bytes) {
  return acc_bytes == 0 ? 0 : acc_bytes == 8 ? ~0ull : (1ull << (8 * acc_bytes)) - 1;
}

}  // namespace

// Pass 1 of a sort: hist uint32 [sum of 2^width over the passes] becomes
// each pass's digits' first output positions (the passes' offsets follow
// each other), kept int64 [1] the number of pairs the sort keeps: those with
// 0 <= acc < limit, or all n when limit is 0.
extern "C" int kw_radix_sort_hist(const void* acc, const void* words, void* hist,
                                  void* kept, int64_t n, int64_t limit, int64_t word_bits,
                                  int64_t acc_bits, int64_t widths, int64_t passes,
                                  void* stream) {
  Plan plan;
  if (n <= 0 || n >= (1LL << 32) || limit < 0 ||
      !make_plan(word_bits, acc_bits, widths, passes, &plan))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(hist, 0, (size_t)plan.total_bins * 4, s))
    return (int)err;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n + kHistThreads - 1) / kHistThreads;
  const int64_t grid = want < 8LL * sms ? want : 8LL * sms;
  radix_hist_kernel<<<(unsigned)grid, kHistThreads, (size_t)plan.total_bins * 4, s>>>(
      (const int64_t*)acc, (const int64_t*)words, n, (uint64_t)limit,
      acc_mask_of(acc_bytes_of(acc_bits)), plan, (uint32_t*)hist);
  radix_base_kernel<<<plan.passes, kBaseThreads, 0, s>>>((uint32_t*)hist, plan,
                                                          (int64_t*)kept);
  return (int)cudaGetLastError();
}

// Pass 2: every pass over the pairs. Pass p reads the pass before's output
// (pass 0: acc and words, keeping what kw_radix_sort_hist counted), writes
// its words to words_a when passes - 1 - p is even and to words_b when it
// is odd (so the last pass writes words_a), and its narrow accessions to
// acc_a / acc_b by p's parity (uint8 for acc_bits <= 8, uint16 for <= 16,
// else int64; none for acc_bits 0); the last pass writes the accessions to
// acc_out as int64 (acc_bits 0: untouched, the caller zero-fills it).
// words_a and acc_out hold n_kept pairs, the other buffers n_kept where a
// pass writes them. lookback: uint64 [lookback_entries], at least the
// largest tiles x 2^width of a pass (tiles of 4096 pairs; pass 0 reads n
// pairs, the others n_kept); counters: uint32 [16].
extern "C" int kw_radix_sort_pairs(const void* acc, const void* words, void* acc_a,
                                   void* acc_b, void* words_a, void* words_b, void* acc_out,
                                   const void* hist, void* lookback, void* counters,
                                   int64_t n, int64_t n_kept, int64_t limit,
                                   int64_t word_bits, int64_t acc_bits, int64_t widths,
                                   int64_t passes, int64_t lookback_entries, void* stream) {
  Plan plan;
  if (n <= 0 || n >= (1LL << 32) || n_kept < 0 || n_kept > n || limit < 0 ||
      (limit == 0 && n_kept != n) || !make_plan(word_bits, acc_bits, widths, passes, &plan))
    return (int)cudaErrorInvalidValue;
  if (n_kept == 0) return 0;
  for (int p = 0; p < plan.passes; ++p) {
    const int64_t rows = p == 0 ? n : n_kept;
    if ((rows + kTile - 1) / kTile * (1LL << plan.width[p]) > lookback_entries)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(lookback, 0, (size_t)lookback_entries * 8, s))
    return (int)err;
  if (cudaError_t err = cudaMemsetAsync(counters, 0, kMaxPasses * 4, s)) return (int)err;
  const int ab = acc_bytes_of(acc_bits);
  void* acc_buf[2] = {acc_a, acc_b};
  uint64_t* words_buf[2] = {(uint64_t*)words_a, (uint64_t*)words_b};
  for (int p = 0; p < plan.passes; ++p) {
    const bool first = p == 0, last = p == plan.passes - 1;
    PassArgs args;
    args.acc_in64 = (const int64_t*)acc;
    args.acc_in = first ? nullptr : acc_buf[(p - 1) & 1];
    args.words_in = first ? (const uint64_t*)words : words_buf[(plan.passes - p) & 1];
    args.acc_out = last ? nullptr : acc_buf[p & 1];
    args.acc_out64 = (int64_t*)acc_out;
    args.words_out = words_buf[(plan.passes - 1 - p) & 1];
    args.n = first ? n : n_kept;
    args.limit = (uint64_t)limit;
    args.shift = plan.shift[p];
    args.width = plan.width[p];
    args.word_bits = plan.word_bits;
    args.acc_bits = plan.acc_bits;
    args.base = (const uint32_t*)hist + plan.offset[p];
    args.lookback = (unsigned long long*)lookback;
    args.tile_counter = (uint32_t*)counters + p;
    args.epoch = (unsigned long long)(p + 1) << kEpochShift;
    cudaError_t err;
    switch (ab) {
      case 0: err = launch_pass_ab<0>(args, first, last, s); break;
      case 1: err = launch_pass_ab<1>(args, first, last, s); break;
      case 2: err = launch_pass_ab<2>(args, first, last, s); break;
      default: err = launch_pass_ab<8>(args, first, last, s); break;
    }
    if (err) return (int)err;
  }
  return 0;
}
