// SriRachA per-read confirmation counts, and the dense subject table.
//
// Replaces: kwage_tpu/sriracha/device.py _kmerize_batch (:50) and
// _kmerize_batch64 (:159) (per-read sort with an all-ones sentinel for
// invalid windows, neighbour-compare dedup) with the probes after them,
// _read_batch_kernel_tables (:239, one LUT gather per distinct word) and
// _read_batch_kernel_hash (:179, one row of 8 (key, mask) slots at bucket
// _mix32(hi, lo) & (2^m - 1), :91); and build_subject_table (:216).
//
// sriracha_counts: from canonical_kmers' words int64 [B, nwin] and valid
// uint8 [B, nwin] and lengths int32 [B], with the valid windows those with
// valid[r, j] and j + k <= len[r]: out[r, ns] = num_kmer (valid windows),
// out[r, ns + 1] = num_unique (distinct words among them), out[r, s] = the
// distinct words whose mask for group s / 32 has bit s % 32 (LUT: table[g *
// 4^k + w], 0 for w >= 4^k; hash: OR of the row's masks whose key is w).
// subject_table: subjects int64 [ns, smax] (words >= 4^k, e.g. the -1
// padding, drop) -> out uint32 [ceil(ns / 32), 4^k], zeroed by the caller,
// bit s % 32 of out[s / 32, w] set iff w is a word of subject s.
// sriracha_reads: the same out as sriracha_counts, from the ASCII reads
// uint8 [B, L] (canonical_kmers' ASCII entry's input) and lengths int32 [B]
// in ONE launch, for rows of at most 512 windows (L - k + 1 <= 512; the
// read buckets of 64-512 bp); the words never reach device memory.
// sriracha_block (sriracha_block.cuh): the same, for rows of at most 2^14
// windows (the read buckets of 1024-16384 bp).
//
// Bound: 9 bytes read per window, then one random 4-byte LUT gather or one
// 96-byte bucket row (64 B keys, 32 B masks) per distinct word and group:
// latency-bound gathers (a 4^11 LUT, 16 MiB a group, sits in the 50 MB L2;
// a 4^14 one, 1 GiB, does not). subject_table: one atomicOr per word.
//
// Design of sriracha_counts: the rows of at most 2^14 windows in their
// read go through the block kernel of sriracha_block.cuh with its words
// source (sriracha_words_lut.cu, sriracha_words_hash.cu), one launch over
// all B rows at any nwin, which writes zeros for every longer row. It sorts
// a row's words under unsigned order with invalid windows as all-ones; the
// validity flag, never the word's value, decides what is kept: the first n
// sorted slots are the n valid words whatever their values, so the k = 32
// word -1 needs no special case. Distinct words (slots that differ from
// their left neighbour) are probed once per group and their masks' set bits
// counted (integer, order-free: bit-exact run to run). All groups' tables
// are one allocation (LUT [G, 4^k]; hash rows concatenated with a first row
// and a bucket mask per group), so the sort runs once and one launch probes
// every group.
//
// sriracha_reads. Bound: the reads' bytes, the lengths and the counts,
// then the same table entry a distinct word and group; the 9 bytes a window
// of canonical_kmers' words and flags are not moved. Design: a warp a read,
// several reads a block, and no block-wide barrier (a half-warp a read was
// slower at every shape timed). The warp stages its read in shared memory
// as 2-bit codes and ok bits (kmers.cuh's decode, so the words are
// canonical_kmers' bit for bit); lane l builds the canonical words of
// windows l E .. l E + E - 1 in registers (E = P / 32, P the batch's
// windows a row rounded up to a power of two; at most 16), invalid ones
// and those past the read as all-ones. The bitonic sort runs on that
// blocked layout in registers: strides below E inside a lane, the others
// as __shfl_xor_sync exchanges with lane l ^ (stride / E); 32-bit keys
// where k <= 16. The valid count decides what is kept, as above. A slot is
// distinct when it differs from its left neighbour (in the lane, or lane
// l - 1's last slot by __shfl_up_sync); the distinct words are compacted
// in shared memory, and lane l probes words l, l + 32, ..., a batch of
// loads issued before any mask is used (LUT: one 4-byte load, all at once;
// hash: the bucket row's 96 bytes in six 16-byte loads, four rows at
// once). The counts are taken per warp: the union of the warp's masks
// (mostly 0: a warp with none skips the counting) names the subjects hit,
// and one warp reduction a hit subject counts its set bits; lane s keeps
// subject s's count and writes it. Nothing is atomic: bit-exact run to run.
//
// Long rows (more than 2^14 windows that fit the read: reads of more than
// 2^14 + k - 1 bases) do not fit a block's shared memory. The first version
// sorted such a row with ONE block in global memory (120 passes with a
// barrier each at P = 2^15: 1.7-1.8 ms a batch). Now a batch wide enough to
// hold long rows (nwin > 2^14) comes with a scratch slab [B, P]; the block
// launch only zeroes a long row's outputs, and a short chain of launches
// over (tile, row) blocks, in which a short row's blocks leave at once
// (every kernel reads the row's length as the block kernel does), sorts the
// long rows across blocks in tiles of 2^14 words (128 KiB of shared memory):
//   1. long_tile_sort: block (tile, row) loads its 2^14 windows (invalid
//      ones as all-ones), adds its valid count to the row's num_kmer, runs
//      every stage up to 2^14 in shared memory, four stages a barrier (each
//      thread takes the 16 slots of four strides into registers), writes
//      the tile;
//   2. per merge level above a tile: long_global_pass for each stride of at
//      least a tile (elementwise in global memory), then long_tile_merge
//      for all the strides below a tile in one shared-memory pass (P = 2^15:
//      one global pass and one tile pass instead of 120 global passes);
//   3. long_probe: block (span, row) dedups and probes 2048 of the row's
//      first num_kmer slots and adds its counts into out by atomicAdd
//      (integer, order-free).
// All offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmers.cuh"
#include "sriracha.cuh"

namespace {

constexpr int64_t kMaxSharedWords = 1 << 14;
constexpr int kThreads = 256;
constexpr int kTileThreads = 1024;
// A tile in shared memory skips one slot in 17, so that the 16 threads of a
// half-warp that each own 16 neighbouring slots fall on 16 different banks.
constexpr int kTileSlots = kTile + (kTile >> 4);
constexpr size_t kTileBytes = (size_t)kTileSlots * sizeof(uint64_t);
constexpr int kProbeSpan = 2048;      // sorted slots per long_probe block

// One compare-exchange of a bitonic stage: ascending where ``asc``.
template <typename Index>
__device__ __forceinline__ void compare_exchange(uint64_t* s, Index i, Index j,
                                                 bool asc) {
  const uint64_t a = s[i], b = s[j];
  if ((a > b) == asc) {
    s[i] = b;
    s[j] = a;
  }
}

// Windows of row r that fit the read: j < min(len - k + 1, nwin).
__device__ __forceinline__ int64_t fitting_windows(const int32_t* lengths, int64_t r,
                                                   int64_t nwin, int k) {
  const int64_t ends = (int64_t)lengths[r] - k + 1;
  return ends < nwin ? ends : nwin;
}

// Every stride below 2^log_top of merge level ``size`` over a padded tile,
// four stages a pass (bits [12, 14), [8, 12), [4, 8), [0, 4) at most): 4
// barriers for the 14 strides of a tile where one stage a pass takes 14.
__device__ __forceinline__ void tile_level(uint64_t* s, int log_top, int64_t base,
                                           int64_t size) {
  for (int hi = log_top; hi > 0;) {
    const int b = (hi - 1) & ~3;
    switch (hi - b) {
      case 1: tile_strides<1>(s, b, base, size); break;
      case 2: tile_strides<2>(s, b, base, size); break;
      case 3: tile_strides<3>(s, b, base, size); break;
      default: tile_strides<4>(s, b, base, size); break;
    }
    __syncthreads();
    hi = b;
  }
}

// --- long rows: tiles of kTile sort slots across blocks -------------------

// Block (tile, row): the tile's windows into shared memory (invalid ones and
// those past the read as all-ones), the valid count into num_kmer, every
// bitonic stage up to kTile (directions from the row-wide index), the tile
// into the row's scratch slab.
__global__ void __launch_bounds__(kTileThreads) long_tile_sort_kernel(const int64_t* __restrict__ words,
                                      const uint8_t* __restrict__ valid,
                                      const int32_t* __restrict__ lengths,
                                      int64_t nwin, int k,
                                      uint64_t* __restrict__ scratch, int64_t P,
                                      int32_t* __restrict__ out,
                                      int64_t out_stride, int ns) {
  extern __shared__ uint64_t s[];
  __shared__ int n_valid;
  const int64_t r = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int64_t last = fitting_windows(lengths, r, nwin, k);
  if (last <= kMaxSharedWords) return;  // the block kernel's row
  const int64_t* wr = words + r * nwin;
  const uint8_t* vr = valid + r * nwin;
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();
  int local = 0;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int64_t j = base + i;
    uint64_t w = ~0ull;
    if (j < last && vr[j]) {
      w = (uint64_t)wr[j];
      ++local;
    }
    s[padded(i)] = w;
  }
  for (int d = 16; d > 0; d >>= 1) local += __shfl_down_sync(0xFFFFFFFFu, local, d);
  if ((threadIdx.x & 31) == 0 && local) atomicAdd(&n_valid, local);
  __syncthreads();
  if (threadIdx.x == 0 && n_valid) atomicAdd(out + r * out_stride + ns, n_valid);
  for (int level = 1; level <= kTileLog; ++level)
    tile_level(s, level, base, (int64_t)1 << level);
  uint64_t* dst = scratch + r * P + base;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) dst[i] = s[padded(i)];
}

// One stage of merge level ``size`` whose stride is at least a tile: every
// pair of long row blockIdx.y, in global memory.
__global__ void long_global_pass_kernel(const int32_t* __restrict__ lengths,
                                        int64_t nwin, int k,
                                        uint64_t* __restrict__ scratch, int64_t P,
                                        int64_t size, int64_t stride) {
  const int64_t r = blockIdx.y;
  if (fitting_windows(lengths, r, nwin, k) <= kMaxSharedWords) return;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < (P >> 1);
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = 2 * t - (t & (stride - 1));
    compare_exchange(scratch + r * P, i, i + stride, (i & size) == 0);
  }
}

// The stages of merge level ``size`` (at least two tiles) whose strides are
// below a tile, in one shared-memory visit: one direction per tile.
__global__ void __launch_bounds__(kTileThreads) long_tile_merge_kernel(const int32_t* __restrict__ lengths,
                                       int64_t nwin, int k,
                                       uint64_t* __restrict__ scratch, int64_t P,
                                       int64_t size) {
  extern __shared__ uint64_t s[];
  const int64_t r = blockIdx.y;
  if (fitting_windows(lengths, r, nwin, k) <= kMaxSharedWords) return;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  uint64_t* tile = scratch + r * P + base;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) s[padded(i)] = tile[i];
  __syncthreads();
  tile_level(s, kTileLog, base, size);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) tile[i] = s[padded(i)];
}

// Block (span, row): dedup and probe kProbeSpan of the row's first num_kmer
// sorted slots (many blocks a row: the probes are latency-bound gathers);
// counts and num_unique add into out.
template <typename Probe>
__global__ void long_probe_kernel(const int32_t* __restrict__ lengths, int64_t nwin,
                                  int k, const uint64_t* __restrict__ scratch,
                                  int64_t P, Probe probe, int ns,
                                  int32_t* __restrict__ out, int64_t out_stride) {
  __shared__ int cnt[32];
  __shared__ int n_unique;
  const int64_t r = blockIdx.y;
  if (fitting_windows(lengths, r, nwin, k) <= kMaxSharedWords) return;
  const uint64_t* s = scratch + r * P;
  const int64_t n = out[r * out_stride + ns];
  const int64_t lo = (int64_t)blockIdx.x * kProbeSpan;
  const int64_t hi = lo + kProbeSpan < n ? lo + kProbeSpan : n;
  if (lo >= hi) return;
  if (threadIdx.x == 0) n_unique = 0;
  __syncthreads();
  int local = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
    local += (i == 0 || s[i] != s[i - 1]);
  if (local) atomicAdd(&n_unique, local);
  for (int s0 = 0, g = 0; s0 < ns; s0 += 32, ++g) {
    const int nsg = ns - s0 < 32 ? ns - s0 : 32;
    if (threadIdx.x < 32) cnt[threadIdx.x] = 0;
    __syncthreads();
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const uint64_t w = s[i];
      if (i > 0 && w == s[i - 1]) continue;
      uint32_t m = probe(g, w);
      while (m) {
        const int bit = __ffs(m) - 1;
        if (bit < nsg) atomicAdd(&cnt[bit], 1);
        m &= m - 1;
      }
    }
    __syncthreads();
    if (threadIdx.x < nsg && cnt[threadIdx.x])
      atomicAdd(out + r * out_stride + s0 + threadIdx.x, cnt[threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(out + r * out_stride + ns + 1, n_unique);
}

int64_t next_pow2(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The tile chain over (tile, row) blocks of a batch wide enough to hold
// long rows (nwin > 2^14; scratch uint64 [B, next_pow2(nwin)]), on the
// stream, after the block launch has zeroed those rows' outputs; nothing
// for a narrower batch.
template <typename Probe>
int launch_long(const void* words, const void* valid, const void* lengths, Probe probe,
                void* out, void* scratch, int64_t B, int64_t nwin, int64_t k, int64_t ns,
                int64_t out_stride, void* stream) {
  if (B == 0 || nwin <= kMaxSharedWords) return 0;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(long_tile_sort_kernel, kTileBytes);
    if (err == cudaSuccess) err = allow_smem(long_tile_merge_kernel, kTileBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t P = next_pow2(nwin);
  const int64_t* w = (const int64_t*)words;
  const uint8_t* v = (const uint8_t*)valid;
  const int32_t* len = (const int32_t*)lengths;
  const dim3 tiles((unsigned)(P / kTile), (unsigned)B);
  uint64_t* sc = (uint64_t*)scratch;
  long_tile_sort_kernel<<<tiles, kTileThreads, kTileBytes, st>>>(
      w, v, len, nwin, (int)k, sc, P, (int32_t*)out, out_stride, (int)ns);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 pairs((unsigned)(P / 2 / kThreads), (unsigned)B);
  for (int64_t size = 2 * (int64_t)kTile; size <= P; size <<= 1) {
    for (int64_t stride = size >> 1; stride >= kTile; stride >>= 1) {
      long_global_pass_kernel<<<pairs, kThreads, 0, st>>>(len, nwin, (int)k, sc, P, size,
                                                          stride);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    long_tile_merge_kernel<<<tiles, kTileThreads, kTileBytes, st>>>(len, nwin, (int)k, sc,
                                                                    P, size);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 spans((unsigned)(P / kProbeSpan), (unsigned)B);
  long_probe_kernel<Probe><<<spans, kThreads, 0, st>>>(
      len, nwin, (int)k, sc, P, probe, (int)ns, (int32_t*)out, out_stride);
  return (int)cudaGetLastError();
}

// Whether sriracha_counts' arguments are usable: a wide batch (nwin >
// 2^14) needs its scratch and at most 65535 rows (the tile chain's grid).
bool counts_args_ok(const void* scratch, int64_t B, int64_t nwin, int64_t k, int64_t ns,
                    int64_t out_stride) {
  const bool wide = nwin > kMaxSharedWords;
  return B >= 0 && nwin >= 1 && k >= 1 && k <= 32 && ns >= 1 && out_stride >= ns + 2 &&
         next_pow2(nwin) <= (int64_t)1 << 30 && !(wide && (scratch == nullptr || B > 65535));
}

// --- short reads: ASCII reads to counts in one launch ---------------------

constexpr int kMaxReadWindows = 512;   // windows a row: reads of 64-512 bp
constexpr int kReadPacked = kMaxReadWindows / 16 + 2;  // packed words a read
constexpr int kReadThreads = 128;      // at most: see launch_reads()

// A read's bases in shared memory: 2-bit codes, 16 a word, and their ok
// bits, 16 a half-word, so that the uint32 word q of ``ok16`` is validity
// word q (bases 32 q .. 32 q + 31).
struct ReadStage {
  uint32_t packed[kReadPacked];
  uint16_t ok16[kReadPacked];
};

// One read a warp, several warps a block; no block-wide barrier. Key:
// uint32 where k <= 16, else uint64. E: sort slots a lane, P = 32 E >= the
// batch's windows a row.
template <typename Probe, typename Key, int E>
__global__ void __launch_bounds__(kReadThreads)
    sriracha_reads_kernel(const uint8_t* __restrict__ reads,
                          const int32_t* __restrict__ lengths, int64_t B, int64_t L,
                          int k, bool aligned, Probe probe, int ns,
                          int32_t* __restrict__ out, int64_t out_stride) {
  constexpr int P = 32 * E;
  constexpr int kPacked = P / 16 + 2;  // packed words windows j < P read
  constexpr int kLogE = E == 1 ? 0 : E == 2 ? 1 : E == 4 ? 2 : E == 8 ? 3 : 4;
  constexpr int kLogP = kLogE + 5;
  __shared__ ReadStage stage[kReadThreads / 32];
  __shared__ Key dist[kReadThreads / 32][P];  // a read's distinct words
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= B) return;
  int64_t len = lengths[r];
  if (len > L) len = L;
  const int n_fit = len - k + 1 > 0 ? (int)(len - k + 1) : 0;  // windows in the read
  int32_t* o = out + r * out_stride;
  if (n_fit == 0) {
    for (int i = lane; i < ns + 2; i += 32) o[i] = 0;
    return;
  }

  // Stage the read: lane q packs bases [16 q, 16 q + 16); bases past the
  // read are code 0 and not ok.
  ReadStage& st = stage[threadIdx.x / 32];
  const uint8_t* row = reads + r * L;
  for (int q = lane; q < kPacked; q += 32) {
    uint32_t coded[4] = {0u, 0u, 0u, 0u};
    const int b0 = 16 * q;
    if (b0 < len) {
      uint32_t x[4] = {0u, 0u, 0u, 0u};
      if (aligned && b0 + 16 <= L) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + b0));
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
        for (int i = 0; i < 16 && b0 + i < L; ++i)
          x[i >> 2] |= (uint32_t)row[b0 + i] << (8 * (i & 3));
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (b0 + i < len)
          coded[i >> 2] |= kw::base_code((x[i >> 2] >> (8 * (i & 3))) & 0xFFu) << (8 * (i & 3));
    }
    uint32_t codes, ok;
    kw::pack16(coded, codes, ok);
    st.packed[q] = codes;
    st.ok16[q] = (uint16_t)ok;
  }
  __syncwarp();

  // Lane l's windows are l E .. l E + E - 1 (the blocked layout); an
  // invalid window, or one past the read, holds all-ones.
  const kw::KmerShape ks(k);
  const uint32_t* validw = reinterpret_cast<const uint32_t*>(st.ok16);
  Key v[E];
  int nvalid = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e, p = j >> 4;
    const bool ok = j < n_fit && kw::window_ok(validw[j >> 5], validw[(j >> 5) + 1], j & 31, ks);
    const uint64_t w = kw::canonical_word(st.packed[p], st.packed[p + 1], st.packed[p + 2],
                                          2 * (j & 15), ks);
    v[e] = ok ? (Key)w : ~Key(0);
    nvalid += ok;
  }

  // Bitonic sort of the P slots, unsigned, ascending: slot j = l E + e.
  // Strides below E are compare-exchanges inside a lane; a stride of E or
  // more pairs lane l with lane l ^ (stride / E), the same e.
#pragma unroll
  for (int ls = 1; ls <= kLogP; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      if (lt >= kLogE) {
        const int lx = 1 << (lt - kLogE);
        // Direction: bit ls of the slot, a lane bit here (0 at ls == kLogP).
        const bool asc = ls == kLogP || ((lane >> (ls - kLogE)) & 1) == 0;
        const bool keep_min = ((lane & lx) == 0) == asc;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const Key o2 = __shfl_xor_sync(kFull, v[e], lx);
          v[e] = keep_min ? (o2 < v[e] ? o2 : v[e]) : (o2 > v[e] ? o2 : v[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & (1 << lt)) == 0) {
            const int f = e | (1 << lt);
            const bool asc = ls >= kLogP || (ls >= kLogE ? ((lane >> (ls - kLogE)) & 1) == 0
                                                          : (e & (1 << ls)) == 0);
            const Key a = v[e], b = v[f];
            const Key lo = a < b ? a : b, hi = a < b ? b : a;
            v[e] = asc ? lo : hi;
            v[f] = asc ? hi : lo;
          }
        }
      }
    }
  }

  // The first n slots hold the n valid words, whatever their values (the
  // k = 32 word -1 included). A slot is distinct when it differs from its
  // left neighbour: in the lane, or lane - 1's last slot. The distinct
  // words move to the front of the read's slots in shared memory (their
  // order kept), so that lane l probes words l, l + 32, ...: about half the
  // probes a lane of the blocked layout, where the padding takes the rest.
  const int n = (int)__reduce_add_sync(kFull, (unsigned)nvalid);
  const Key left = __shfl_up_sync(kFull, v[E - 1], 1);
  bool distinct[E];
  int nd = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    const Key prev = e > 0 ? v[e - 1] : left;
    distinct[e] = j < n && (j == 0 || v[e] != prev);
    nd += distinct[e];
  }
  int first = nd;  // inclusive scan of nd over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, first, d);
    if (lane >= d) first += t;
  }
  const int nu = __shfl_sync(kFull, first, 31);
  first -= nd;
  Key* words = dist[threadIdx.x / 32];
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (distinct[e]) words[first++] = v[e];
  __syncwarp();

  // A group's probes go out C at a time (the LUT's all at once), every
  // load of the C before any result is used; the set bits are then counted
  // by subject over the warp, one reduction a subject that some lane hit
  // (the union of the warp's masks: mostly none), two subjects at a time,
  // and lane s keeps subject s's count.
  constexpr int C = E < Probe::kInFlight ? E : Probe::kInFlight;
  for (int s0 = 0, g = 0; s0 < ns; s0 += 32, ++g) {
    uint32_t m[E];
#pragma unroll
    for (int e = 0; e < E; ++e) m[e] = 0u;
#pragma unroll
    for (int c0 = 0; c0 < E; c0 += C) {
      if (c0 * 32 >= nu) break;
      typename Probe::Row rows[C];
      Key w[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int idx = (c0 + i) * 32 + lane;
        w[i] = idx < nu ? words[idx] : ~Key(0);
        if (idx < nu) rows[i] = probe.load(g, (uint64_t)w[i]);
      }
#pragma unroll
      for (int i = 0; i < C; ++i)
        if ((c0 + i) * 32 + lane < nu) m[c0 + i] = probe.mask(rows[i], (uint64_t)w[i]);
    }
    uint32_t any = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) any |= m[e];
    int cnt = 0;
    for (uint32_t bits = __reduce_or_sync(kFull, any); bits;) {
      const int b0 = __ffs(bits) - 1;
      bits &= bits - 1;
      const int b1 = __ffs(bits) - 1;  // -1: none left
      bits &= bits - 1;
      int c0 = 0, c1 = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        c0 += (m[e] >> b0) & 1u;
        c1 += b1 >= 0 ? (m[e] >> b1) & 1u : 0u;
      }
      c0 = (int)__reduce_add_sync(kFull, (unsigned)c0);
      c1 = (int)__reduce_add_sync(kFull, (unsigned)c1);
      cnt = lane == b0 ? c0 : lane == b1 ? c1 : cnt;
    }
    if (lane < ns - s0) o[s0 + lane] = cnt;
  }
  if (lane == 0) {
    o[ns] = n;
    o[ns + 1] = nu;
  }
}

template <typename Probe>
using ReadKernel = void (*)(const uint8_t*, const int32_t*, int64_t, int64_t, int, bool,
                            Probe, int, int32_t*, int64_t);

template <typename Probe, typename Key>
ReadKernel<Probe> read_kernel(int E) {
  switch (E) {
    case 1: return sriracha_reads_kernel<Probe, Key, 1>;
    case 2: return sriracha_reads_kernel<Probe, Key, 2>;
    case 4: return sriracha_reads_kernel<Probe, Key, 4>;
    case 8: return sriracha_reads_kernel<Probe, Key, 8>;
    default: return sriracha_reads_kernel<Probe, Key, 16>;
  }
}

// One launch over all B rows of at most kMaxReadWindows windows.
template <typename Probe>
int launch_reads(const void* reads, const void* lengths, Probe probe, void* out, int64_t B,
                 int64_t L, int64_t k, int64_t ns, int64_t out_stride, void* stream) {
  const int64_t nwin = L - k + 1;
  if (B < 0 || k < 1 || k > 32 || nwin < 1 || nwin > kMaxReadWindows || ns < 1 ||
      out_stride < ns + 2)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int E = 1;
  while (32 * E < nwin) E <<= 1;
  int warps = kReadThreads / 32;  // fewer while the blocks would not cover the SMs twice
  while (warps > 1 && B / warps < 2 * 132) warps >>= 1;
  const int64_t blocks = (B + warps - 1) / warps;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)reads & 15u) == 0 && (L & 15) == 0;
  const ReadKernel<Probe> kernel = k <= 16 ? read_kernel<Probe, uint32_t>(E)
                                           : read_kernel<Probe, unsigned long long>(E);
  kernel<<<(unsigned)blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)reads, (const int32_t*)lengths, B, L, (int)k, aligned, probe, (int)ns,
      (int32_t*)out, out_stride);
  return (int)cudaGetLastError();
}

__global__ void subject_table_kernel(const int64_t* __restrict__ subjects,
                                     int64_t total, int64_t smax, int64_t size,
                                     uint32_t* __restrict__ out) {
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const uint64_t w = (uint64_t)subjects[t];
    if (w >= (uint64_t)size) continue;  // padding and out-of-range words drop
    const int64_t s = t / smax;
    atomicOr(out + (s >> 5) * size + (int64_t)w, 1u << (s & 31));
  }
}

}  // namespace

// The block kernel's words entries (sriracha_words_lut.cu,
// sriracha_words_hash.cu): every row of at most 2^14 windows, zeros for the
// rest.
extern "C" int kw_sriracha_words_lut(const void* words, const void* valid, const void* lengths,
                                     const void* table, void* out, int64_t B, int64_t nwin,
                                     int64_t k, int64_t size, int64_t ns, int64_t out_stride,
                                     void* stream);
extern "C" int kw_sriracha_words_hash(const void* words, const void* valid, const void* lengths,
                                      const void* keys, const void* masks, const void* row0,
                                      const void* bmask, void* out, int64_t B, int64_t nwin,
                                      int64_t k, int64_t ns, int64_t out_stride, void* stream);

// (words, valid, lengths, table, out, scratch, B, nwin, k, size, ns,
//  out_stride, stream); scratch may be null when nwin <= 2^14. The block
// launch, then the tile chain for a wide batch.
extern "C" int kw_sriracha_counts_lut(const void* words, const void* valid,
                                      const void* lengths, const void* table,
                                      void* out, void* scratch, int64_t B,
                                      int64_t nwin, int64_t k, int64_t size,
                                      int64_t ns, int64_t out_stride,
                                      void* stream) {
  if (size < 1 || !counts_args_ok(scratch, B, nwin, k, ns, out_stride))
    return (int)cudaErrorInvalidValue;
  const int err = kw_sriracha_words_lut(words, valid, lengths, table, out, B, nwin, k, size,
                                        ns, out_stride, stream);
  if (err) return err;
  return launch_long(words, valid, lengths, LutProbe{(const uint32_t*)table, size}, out,
                     scratch, B, nwin, k, ns, out_stride, stream);
}

// (words, valid, lengths, keys, masks, row0, bmask, out, scratch, B, nwin, k,
//  ns, out_stride, stream)
extern "C" int kw_sriracha_counts_hash(const void* words, const void* valid,
                                       const void* lengths, const void* keys,
                                       const void* masks, const void* row0,
                                       const void* bmask, void* out,
                                       void* scratch, int64_t B, int64_t nwin,
                                       int64_t k, int64_t ns, int64_t out_stride,
                                       void* stream) {
  if (!counts_args_ok(scratch, B, nwin, k, ns, out_stride)) return (int)cudaErrorInvalidValue;
  const int err = kw_sriracha_words_hash(words, valid, lengths, keys, masks, row0, bmask, out,
                                         B, nwin, k, ns, out_stride, stream);
  if (err) return err;
  return launch_long(words, valid, lengths,
                     HashProbe{(const unsigned long long*)keys, (const uint32_t*)masks,
                               (const long long*)row0, (const long long*)bmask},
                     out, scratch, B, nwin, k, ns, out_stride, stream);
}

// (reads, lengths, table, out, B, L, k, size, ns, out_stride, stream):
// ASCII reads uint8 [B, L], L - k + 1 <= 512.
extern "C" int kw_sriracha_reads_lut(const void* reads, const void* lengths,
                                     const void* table, void* out, int64_t B, int64_t L,
                                     int64_t k, int64_t size, int64_t ns,
                                     int64_t out_stride, void* stream) {
  if (size < 1) return (int)cudaErrorInvalidValue;
  return launch_reads(reads, lengths, LutProbe{(const uint32_t*)table, size}, out, B, L, k,
                      ns, out_stride, stream);
}

// (reads, lengths, keys, masks, row0, bmask, out, B, L, k, ns, out_stride,
//  stream)
extern "C" int kw_sriracha_reads_hash(const void* reads, const void* lengths,
                                      const void* keys, const void* masks,
                                      const void* row0, const void* bmask, void* out,
                                      int64_t B, int64_t L, int64_t k, int64_t ns,
                                      int64_t out_stride, void* stream) {
  return launch_reads(reads, lengths,
                      HashProbe{(const unsigned long long*)keys, (const uint32_t*)masks,
                                (const long long*)row0, (const long long*)bmask},
                      out, B, L, k, ns, out_stride, stream);
}

// (subjects, out, ns, smax, size, stream)
extern "C" int kw_subject_table(const void* subjects, void* out, int64_t ns,
                                int64_t smax, int64_t size, void* stream) {
  if (ns < 0 || smax < 0 || size < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = ns * smax;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  subject_table_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)subjects, total, smax, size, (uint32_t*)out);
  return (int)cudaGetLastError();
}
