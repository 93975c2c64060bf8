// radix_sort_pairs: the ingest's sort of (accession, word) windows.
//
// Replaces: kwage_tpu/ops/counting.py _sort_words and the accession key of
// _count_multi_core (jax.lax.sort, which XLA compiled on the TPU).
//
// Inputs: acc int64 [n], words int64 [n]. Output: the same pairs ordered by
// (acc, word), both compared as signed int64. Equal pairs cannot be told
// apart, so the output is one fixed array of bits whatever the order of
// equal elements; every pass below is stable all the same, because an LSD
// radix sort is only right when each pass keeps the order the earlier
// passes made.
//
// Bound: bytes. A pass reads both arrays and writes both (32 B a pair) and
// reads the pass's key once more for the histogram (8 B a pair); the digit
// arithmetic is a few integer operations a pair.
//
// Design (simple and right first): least-significant-digit radix sort on
// 8-bit digits, over the low `word_digits` bytes of the word and then the
// low `acc_digits` bytes of the accession (the caller knows how many bytes
// can differ: ceil(2k/8) and the bytes of num_acc; the digits above them
// are constant and skipped). The digit at bit 56 has its top bit flipped,
// which orders two's-complement values (a word at k = 32 fills 64 bits).
// One pass is three kernels:
//   1. radix_hist:    a block counts the digits of its tile of 4096 pairs
//                     (warp-aggregated shared-memory atomics) into
//                     hist[digit][block];
//   2. radix_scan:    one block a digit turns its row of hist into an
//                     exclusive prefix over the blocks and writes the
//                     digit's total;
//   3. radix_scatter: a block re-reads its tile, ranks each pair among the
//                     pairs of the same digit before it in the tile, and
//                     writes it to (digits below) + (same digit in earlier
//                     blocks) + (rank in the tile). The rank is stable: a
//                     warp owns 512 consecutive pairs and takes them 32 at
//                     a time in order; __match_any_sync finds the lanes of
//                     one digit, the lowest of them bumps the warp's digit
//                     counter in shared memory, and a lane's rank is the
//                     counter before the bump plus the matching lanes below
//                     it; the 8 warps' counters are then prefixed in warp
//                     order.
// The passes ping-pong between two scratch pairs; the input is only read.
// Offsets are 32-bit pair indices (n < 2^32) widened to 64 bits before they
// scale to bytes. Decoupled look-back, a fused 64-bit key for k <= 31, a
// shared-memory staged (coalesced) scatter and folding select_runs into the
// last pass are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // pairs a thread
constexpr int kTile = kThreads * kItems;    // pairs a block: 4096
constexpr int kPerWarp = 32 * kItems;       // consecutive pairs a warp: 512
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoDigit = 256;          // a lane past n

__device__ __forceinline__ uint32_t digit_of(int64_t key, int shift) {
  const uint32_t d = (uint32_t)((uint64_t)key >> shift) & 0xffu;
  return shift == 56 ? d ^ 0x80u : d;
}

__global__ void radix_hist_kernel(const int64_t* __restrict__ keys, int64_t n,
                                  int shift, uint32_t* __restrict__ hist,
                                  int64_t nblocks) {
  __shared__ uint32_t h[257];
  const int t = threadIdx.x, lane = t & 31;
  h[t] = 0;
  if (t == 0) h[256] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile + t;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + (int64_t)r * kThreads;
    const uint32_t d = i < n ? digit_of(keys[i], shift) : kNoDigit;
    const unsigned same = __match_any_sync(kFull, d);
    if (lane == __ffs(same) - 1) atomicAdd(&h[d], (uint32_t)__popc(same));
  }
  __syncthreads();
  hist[(int64_t)t * nblocks + blockIdx.x] = h[t];
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

// Block d: hist[d][0..nblocks) -> its exclusive prefix, totals[d] = its sum.
__global__ void radix_scan_kernel(uint32_t* __restrict__ hist, int64_t nblocks,
                                  uint32_t* __restrict__ totals) {
  __shared__ uint32_t wsum[32];
  uint32_t* row = hist + (int64_t)blockIdx.x * nblocks;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t carry = 0;
  for (int64_t c0 = 0; c0 < nblocks; c0 += kScanThreads) {
    const int64_t i = c0 + t;
    const uint32_t v = i < nblocks ? row[i] : 0u;
    const uint32_t inc = warp_inclusive_scan(v, lane);
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    if (warp == 0) wsum[lane] = warp_inclusive_scan(wsum[lane], lane);
    __syncthreads();
    const uint32_t before = warp ? wsum[warp - 1] : 0u;
    if (i < nblocks) row[i] = carry + before + inc - v;
    carry += wsum[31];
    __syncthreads();
  }
  if (t == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const int64_t* __restrict__ acc_in,
                     const int64_t* __restrict__ words_in,
                     int64_t* __restrict__ acc_out,
                     int64_t* __restrict__ words_out, int64_t n, int shift,
                     int key_is_acc, const uint32_t* __restrict__ hist,
                     const uint32_t* __restrict__ totals, int64_t nblocks) {
  __shared__ uint32_t cnt[kWarps][257];   // per warp: pairs of each digit
  __shared__ uint32_t base[256];          // first output index of each digit
  __shared__ uint32_t wsum[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = t; j < kWarps * 257; j += kThreads) (&cnt[0][0])[j] = 0;

  // base[d] = pairs of smaller digits + pairs of digit d in earlier blocks.
  const uint32_t tot = totals[t];
  const uint32_t inc = warp_inclusive_scan(tot, lane);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  uint32_t below = 0;
  for (int j = 0; j < warp; ++j) below += wsum[j];
  base[t] = below + inc - tot + hist[(int64_t)t * nblocks + blockIdx.x];

  int64_t a[kItems], w[kItems];
  uint32_t place[kItems];                 // digit << 16 | rank in the warp
  const int64_t first = (int64_t)blockIdx.x * kTile + warp * kPerWarp + lane;
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = first + r * 32;
    const bool live = i < n;
    a[r] = live ? acc_in[i] : 0;
    w[r] = live ? words_in[i] : 0;
    const uint32_t d = live ? digit_of(key_is_acc ? a[r] : w[r], shift) : kNoDigit;
    const unsigned same = __match_any_sync(kFull, d);
    const int leader = __ffs(same) - 1;
    uint32_t before = 0;
    if (lane == leader) {
      before = cnt[warp][d];
      cnt[warp][d] = before + (uint32_t)__popc(same);
    }
    before = __shfl_sync(kFull, before, leader);
    place[r] = (d << 16) | (before + (uint32_t)__popc(same & lanes_below));
    __syncwarp();   // the next round's leader reads this round's counter
  }
  __syncthreads();
  {  // thread d: the warps' counts of digit d -> exclusive prefix in warp order
    uint32_t run = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const uint32_t c = cnt[j][t];
      cnt[j][t] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const uint32_t d = place[r] >> 16;
    if (d == kNoDigit) continue;
    const int64_t pos = (int64_t)base[d] + cnt[warp][d] + (place[r] & 0xffffu);
    acc_out[pos] = a[r];
    words_out[pos] = w[r];
  }
}

}  // namespace

// Sorts (acc, words) [n] by (acc, word) over the low word_digits bytes of
// the word and the low acc_digits bytes of the accession. Pass p writes
// scratch pair p & 1 (pair 0: acc_a/words_a; pair 1: acc_b/words_b) and
// reads the pair the pass before wrote (pass 0: the input), so the result
// is in pair (word_digits + acc_digits - 1) & 1. hist: uint32
// [256 * ceil(n / 4096)], totals: uint32 [256].
extern "C" int kw_radix_sort_pairs(const void* acc, const void* words,
                                   void* acc_a, void* words_a, void* acc_b,
                                   void* words_b, void* hist, void* totals,
                                   int64_t n, int64_t word_digits,
                                   int64_t acc_digits, void* stream) {
  if (n <= 0 || n >= (1LL << 32) || word_digits < 0 || word_digits > 8 ||
      acc_digits < 0 || acc_digits > 8 || word_digits + acc_digits < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t nblocks = (n + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* src_acc = (const int64_t*)acc;
  const int64_t* src_words = (const int64_t*)words;
  int64_t* dst_acc[2] = {(int64_t*)acc_a, (int64_t*)acc_b};
  int64_t* dst_words[2] = {(int64_t*)words_a, (int64_t*)words_b};
  for (int64_t p = 0; p < word_digits + acc_digits; ++p) {
    const int key_is_acc = p >= word_digits;
    const int shift = 8 * (int)(key_is_acc ? p - word_digits : p);
    radix_hist_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
        key_is_acc ? src_acc : src_words, n, shift, (uint32_t*)hist, nblocks);
    radix_scan_kernel<<<256, kScanThreads, 0, s>>>((uint32_t*)hist, nblocks,
                                                   (uint32_t*)totals);
    radix_scatter_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(
        src_acc, src_words, dst_acc[p & 1], dst_words[p & 1], n, shift,
        key_is_acc, (const uint32_t*)hist, (const uint32_t*)totals, nblocks);
    if (cudaError_t err = cudaGetLastError()) return (int)err;
    src_acc = dst_acc[p & 1];
    src_words = dst_words[p & 1];
  }
  return 0;
}
