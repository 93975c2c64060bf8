// SriRachA per-read confirmation counts for rows of at most 2^14 windows,
// a block a row: the kernel of sriracha_block_{lut,hash}.cu (from ASCII
// reads) and sriracha_words_{lut,hash}.cu (from canonical words), one
// probe a file, so that nvcc compiles the four sets of instances side by
// side.
//
// Replaces: kwage_tpu/sriracha/device.py _kmerize_batch (:50) and
// _kmerize_batch64 (:159) with _read_batch_kernel_tables (:239) and
// _read_batch_kernel_hash (:179), at those rows' widths.
//
// sriracha_block: sriracha_counts' out (sriracha.cu) from the ASCII reads
// uint8 [B, L] and lengths int32 [B] in ONE launch, for rows of at most
// 2^14 windows (L - k + 1 <= 2^14: the read buckets of 1024-16384 bp); the
// words never reach device memory. sriracha_words: the same out from
// canonical_kmers' words int64 [B, nwin] and validity uint8 [B, nwin] (row
// stride nwin, any nwin), for every row of at most 2^14 windows that fit
// its read; a longer row gets zeros, into which sriracha_counts' tile chain
// adds.
//
// Bound: as sriracha_reads' (sriracha.cu); the words source reads the 9
// bytes of every window that fits its read in place of the read's bytes.
// What held the first design (one block a row of canonical_kmers' words)
// back on these rows: at most 256 threads a row sorting 64-bit keys in
// shared memory with a barrier a bitonic stage (105 at P = 2^14), a shared atomic counter for
// the compaction, probes one at a time and a shared atomic a set bit (and,
// from ASCII, the 9 bytes a window of canonical_kmers' output written and
// read back). Design: a block of T = P / 16 threads a row (32 at P = 512,
// the words entry's narrowest, and 64 at P = 1024, so that several blocks
// share an SM; 1024 at P = 2^14); a source fills
// thread t's 16 slots, windows 16 t .. 16 t + 15, in registers (32-bit
// keys where k <= 16, whose words fit 32 bits): AsciiSource stages the
// read as sriracha_reads stages it and builds the canonical words there,
// WordsSource loads the words and flags coalesced (consecutive threads,
// consecutive windows) into padded shared memory and takes its slots from
// there. The rest is one code path for both. The bitonic sort keeps strides
// below 16 in a thread and strides of 16-256 in __shfl_xor_sync exchanges;
// a merge level with strides of 512 and more goes through padded shared
// memory, up to four strides a barrier (tile_strides, as the long-row
// tiles do): 11 barriers at P = 2^14. The distinct words are compacted by
// ballots, warp by warp, to the front of shared memory; thread t probes
// words t, t + T, ..., several loads in flight before any mask is used
// (fewer hash rows at 512-1024 threads, where the registers are fewer). A
// hash probe reads its row's 64 bytes of keys and then only the matching
// slot's 4-byte mask (HashProbe::load_keys / mask_of): a miss reads two
// sectors, not the row's three (timed beside the whole row on an H100 80GB
// HBM3 at 700 W: 0.066 against 0.102 ms at [512, 2048], k = 21). Each
// warp counts its masks' set bits by warp reductions over their union, and
// warp 0 adds the warps' counts up. Nothing is atomic.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "kmers.cuh"
#include "sriracha.cuh"

namespace {

// --- rows of at most 2^14 windows: to counts in one launch, a block a row

constexpr int kMaxBlockLog = 14;
constexpr int kMaxBlockWindows = 1 << kMaxBlockLog;  // windows a row: reads up to 16 kbp
constexpr int kMinBlockLog = 9;            // the smallest block, one warp, sorts 512 slots
constexpr int kSlotLog = 4;                // sort slots a thread: 16
constexpr int kSlots = 1 << kSlotLog;
constexpr int kWarpSlotLog = kSlotLog + 5;  // a warp's slots: strides below 512

// Probes a thread keeps in flight in a block of T threads: the probe's own
// number, fewer where their rows (a hash row's keys and slot take 20
// registers) would not fit the registers an SM gives each thread beside
// the ~40 the loop holds; a power of two, so that the batches tile a
// thread's 16 probes.
template <typename Probe>
__host__ __device__ constexpr int block_in_flight(int T) {
  const int rows = (65536 / T - 40) / (int)(sizeof(typename Probe::Keys) / 4);
  int c = 1;
  while (2 * c <= rows && 2 * c <= Probe::kInFlight) c *= 2;
  return c;
}

// One stage of the 16 slots a thread holds, stride 2^LT < 16: slot e meets
// slot e + 2^LT. Slot j = 16 t + e of merge level 2^ls is ascending iff bit
// ls of j is 0: a bit of e below 16, else bit ls - 4 of the thread.
template <int LT, typename Key>
__device__ __forceinline__ void thread_stage(Key (&v)[kSlots], int ls, int t) {
  const bool up = ls >= kSlotLog && ((t >> (ls - kSlotLog)) & 1) == 0;
#pragma unroll
  for (int e = 0; e < kSlots; ++e) {
    if ((e & (1 << LT)) == 0) {
      const int f = e | (1 << LT);
      const bool asc = ls >= kSlotLog ? up : ((e >> ls) & 1) == 0;
      const Key a = v[e], b = v[f];
      const Key lo = a < b ? a : b, hi = a < b ? b : a;
      v[e] = asc ? lo : hi;
      v[f] = asc ? hi : lo;
    }
  }
}

// A row's slots from ASCII reads uint8 [B, L]: the read staged in shared
// memory as the warp kernel stages it (thread q packs bases [16 q, 16 q +
// 16) into 2-bit codes and ok bits; bases past the read are code 0 and not
// ok), then thread t's canonical words of windows 16 t .. 16 t + 15 from
// packed words t .. t + 2 and validity words t / 2, t / 2 + 1.
struct AsciiSource {
  const uint8_t* reads;
  int64_t L;
  bool aligned;  // reads on a 16-byte boundary, L a multiple of 16
  template <int T>
  struct Stage {
    uint32_t packed[T + 2];  // packed words windows j < 16 T read
    uint16_t ok16[T + 2];    // 4-byte aligned: it follows packed
  };
  // Thread t's slots (invalid windows and those past the read all-ones);
  // returns how many of them are valid.
  template <int T, typename Key>
  __device__ int fill(Stage<T>& st, Key*, int64_t r, int n_fit, int k, Key (&v)[kSlots]) const {
    const int t = threadIdx.x;
    const int64_t len = (int64_t)n_fit + k - 1;  // the read's bases within L
    const uint8_t* row = reads + r * L;
    for (int q = t; q < T + 2; q += T) {
      uint32_t coded[4] = {0u, 0u, 0u, 0u};
      const int64_t b0 = 16 * (int64_t)q;
      if (b0 < len) {
        uint32_t x[4] = {0u, 0u, 0u, 0u};
        if (aligned && b0 + 16 <= L) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + b0));
          x[0] = w.x;
          x[1] = w.y;
          x[2] = w.z;
          x[3] = w.w;
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
    __syncthreads();
    const kw::KmerShape ks(k);
    const uint32_t* validw = reinterpret_cast<const uint32_t*>(st.ok16);
    const uint32_t w0 = st.packed[t], w1 = st.packed[t + 1], w2 = st.packed[t + 2];
    const uint32_t v0 = validw[t >> 1], v1 = validw[(t >> 1) + 1];
    int nvalid = 0;
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      const bool ok = t * kSlots + e < n_fit && kw::window_ok(v0, v1, (t & 1) * 16 + e, ks);
      const uint64_t w = kw::canonical_word(w0, w1, w2, 2 * e, ks);
      v[e] = ok ? (Key)w : ~Key(0);
      nvalid += ok;
    }
    return nvalid;
  }
};

// A row's slots from canonical_kmers' words int64 [B, nwin] and validity
// uint8 [B, nwin] (row stride nwin): thread t loads windows t, t + T, ...
// (a warp's loads are consecutive), keys of the valid ones that fit the
// read and all-ones for the rest, into the padded sort buffer, and after a
// barrier takes slots 16 t .. 16 t + 15 from there (17 t + e: no bank
// conflict). Words of k <= 16 are below 4^16 and fit the 32-bit key.
struct WordsSource {
  const int64_t* words;
  const uint8_t* valid;
  int64_t nwin;
  template <int T>
  struct Stage {};
  template <int T, typename Key>
  __device__ int fill(Stage<T>&, Key* s, int64_t r, int n_fit, int, Key (&v)[kSlots]) const {
    const int t = threadIdx.x;
    const int64_t* wr = words + r * nwin;
    const uint8_t* vr = valid + r * nwin;
    int nvalid = 0;
#pragma unroll
    for (int e = 0; e < kSlots; ++e) {
      const int j = e * T + t;
      Key x = ~Key(0);
      if (j < n_fit) {
        const int64_t w = __ldg(wr + j);
        if (__ldg(vr + j)) {
          x = (Key)w;
          ++nvalid;
        }
      }
      s[padded(j)] = x;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kSlots; ++e) v[e] = s[padded(t * kSlots + e)];
    return nvalid;
  }
};

// One row a block of T = P / 16 threads, 16 sort slots a thread in
// registers; P = 2^LogP >= the windows of every row it sorts. Key: uint32
// where k <= 16, else uint64. Dynamic shared memory: P + P / 16 keys. A row
// with no window in its read, or with more than P (a words batch wider
// than 2^14 windows), gets zeros.
template <typename Source, typename Probe, typename Key, int LogP>
__global__ void __launch_bounds__((1 << LogP) >> kSlotLog)
    sriracha_block_kernel(Source src, const int32_t* __restrict__ lengths, int64_t nwin, int k,
                          Probe probe, int ns, int32_t* __restrict__ out, int64_t out_stride) {
  constexpr int P = 1 << LogP;
  constexpr int T = P >> kSlotLog;
  constexpr int kWarps = T / 32;
  constexpr int C = block_in_flight<Probe>(T);
  extern __shared__ __align__(16) unsigned char smem[];
  Key* s = reinterpret_cast<Key*>(smem);  // the sort, then the distinct words
  __shared__ typename Source::template Stage<T> stage;
  __shared__ int s_valid[kWarps], s_dist[kWarps];
  __shared__ Key s_last[kWarps];
  __shared__ int s_counts[2][kWarps][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t r = blockIdx.x;
  const int64_t ends = (int64_t)lengths[r] - k + 1;
  const int64_t fit = ends < nwin ? ends : nwin;  // windows in the read
  int32_t* o = out + r * out_stride;
  if (fit <= 0 || fit > P) {
    for (int i = t; i < ns + 2; i += T) o[i] = 0;
    return;
  }
  const int n_fit = (int)fit;

  Key v[kSlots];
  int nvalid = src.template fill<T>(stage, s, r, n_fit, k, v);
  nvalid = (int)__reduce_add_sync(kFull, (unsigned)nvalid);
  if (lane == 0) s_valid[warp] = nvalid;

  // Bitonic sort of the P slots, unsigned, ascending: slot j = 16 t + e.
  // A merge level with strides of 512 or more writes the slots to shared
  // memory (padded: thread t's 16 slots start at 17 t, so a warp's stores
  // fall on distinct banks), runs those strides there up to four a barrier
  // (tile_strides), and reads its slots back; strides of 16-256 pair lane
  // l with lane l ^ (stride / 16), the same e; strides below 16 stay in a
  // thread. At P = 2^14: 11 barriers.
  for (int ls = 1; ls <= LogP; ++ls) {
    if (ls > kWarpSlotLog) {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) s[padded(t * kSlots + e)] = v[e];
      __syncthreads();
      for (int hi = ls; hi > kWarpSlotLog;) {
        const int b = hi - 4 > kWarpSlotLog ? hi - 4 : kWarpSlotLog;
        switch (hi - b) {
          case 1: tile_strides<1, Key, P>(s, b, 0, (int64_t)1 << ls); break;
          case 2: tile_strides<2, Key, P>(s, b, 0, (int64_t)1 << ls); break;
          case 3: tile_strides<3, Key, P>(s, b, 0, (int64_t)1 << ls); break;
          default: tile_strides<4, Key, P>(s, b, 0, (int64_t)1 << ls); break;
        }
        __syncthreads();
        hi = b;
      }
#pragma unroll
      for (int e = 0; e < kSlots; ++e) v[e] = s[padded(t * kSlots + e)];
    }
    const bool asc = ls < kSlotLog || ((t >> (ls - kSlotLog)) & 1) == 0;
    for (int lt = (ls < kWarpSlotLog ? ls : kWarpSlotLog) - 1; lt >= kSlotLog; --lt) {
      const int lx = 1 << (lt - kSlotLog);
      const bool keep_min = ((lane & lx) == 0) == asc;
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        const Key o2 = __shfl_xor_sync(kFull, v[e], lx);
        v[e] = keep_min ? (o2 < v[e] ? o2 : v[e]) : (o2 > v[e] ? o2 : v[e]);
      }
    }
    if (ls > 3) thread_stage<3>(v, ls, t);
    if (ls > 2) thread_stage<2>(v, ls, t);
    if (ls > 1) thread_stage<1>(v, ls, t);
    thread_stage<0>(v, ls, t);
  }

  // The first n slots hold the n valid words, whatever their values. A
  // slot is distinct when it differs from its left neighbour: in the
  // thread, thread t - 1's last slot (a shuffle), or the last slot of the
  // warp before (shared memory).
  if (lane == 31) s_last[warp] = v[kSlots - 1];
  __syncthreads();
  int n = 0;
  for (int w = 0; w < kWarps; ++w) n += s_valid[w];
  Key left = __shfl_up_sync(kFull, v[kSlots - 1], 1);
  if (lane == 0 && warp > 0) left = s_last[warp - 1];
  uint32_t dmask = 0;  // bit e: slot 16 t + e is distinct
#pragma unroll
  for (int e = 0; e < kSlots; ++e) {
    const int j = t * kSlots + e;
    const Key prev = e > 0 ? v[e - 1] : left;
    dmask |= (uint32_t)(j < n && (j == 0 || v[e] != prev)) << e;
  }
  const int warp_nd = (int)__reduce_add_sync(kFull, (unsigned)__popc(dmask));
  if (lane == 0) s_dist[warp] = warp_nd;
  __syncthreads();

  // The distinct words move to the front of shared memory, warp by warp:
  // a warp's go out slot column by slot column (a ballot each, so that
  // the lanes of a column store next to each other); thread t then probes
  // words t, t + T, ..., 16 at most.
  int first = 0, nu = 0;
  for (int w = 0; w < kWarps; ++w) {
    first += w < warp ? s_dist[w] : 0;
    nu += s_dist[w];
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int e = 0; e < kSlots; ++e) {
    const unsigned ballot = __ballot_sync(kFull, (dmask >> e) & 1u);
    if ((dmask >> e) & 1u) s[first + __popc(ballot & below)] = v[e];
    first += __popc(ballot);
  }
  __syncthreads();

  // A group's probes go out C at a time, every load of the C before any
  // result is used; each batch's set bits are counted by subject over the
  // warp (one reduction a subject that some lane hit, two at a time), lane
  // s keeps the warp's count of subject s, and warp 0 adds the warps'
  // counts up. Nothing is atomic: bit-exact run to run.
  for (int s0 = 0, g = 0; s0 < ns; s0 += 32, ++g) {
    int cnt = 0;
#pragma unroll
    for (int c0 = 0; c0 < kSlots; c0 += C) {
      if (c0 * T >= nu) break;
      typename Probe::Keys rows[C];
      Key w[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int idx = (c0 + i) * T + t;
        w[i] = idx < nu ? s[idx] : ~Key(0);
        if (idx < nu) rows[i] = probe.load_keys(g, (uint64_t)w[i]);
      }
      uint32_t m[C];
      uint32_t any = 0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        m[i] = (c0 + i) * T + t < nu ? probe.mask_of(rows[i], (uint64_t)w[i]) : 0u;
        any |= m[i];
      }
      for (uint32_t bits = __reduce_or_sync(kFull, any); bits;) {
        const int b0 = __ffs(bits) - 1;
        bits &= bits - 1;
        const int b1 = __ffs(bits) - 1;  // -1: none left
        bits &= bits - 1;
        int c0n = 0, c1n = 0;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          c0n += (m[i] >> b0) & 1u;
          c1n += b1 >= 0 ? (m[i] >> b1) & 1u : 0u;
        }
        c0n = (int)__reduce_add_sync(kFull, (unsigned)c0n);
        c1n = (int)__reduce_add_sync(kFull, (unsigned)c1n);
        cnt += lane == b0 ? c0n : lane == b1 ? c1n : 0;
      }
    }
    s_counts[g & 1][warp][lane] = cnt;
    __syncthreads();
    if (warp == 0 && lane < ns - s0) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += s_counts[g & 1][w][lane];
      o[s0 + lane] = sum;
    }
  }
  if (t == 0) {
    o[ns] = n;
    o[ns + 1] = nu;
  }
}

template <typename Source, typename Probe>
using BlockKernel = void (*)(Source, const int32_t*, int64_t, int, Probe, int, int32_t*, int64_t);

// The instance of P = 2^log_p, its shared memory allowed at its first use.
template <typename Source, typename Probe, typename Key>
cudaError_t block_kernel(int log_p, BlockKernel<Source, Probe>* kernel, size_t* smem) {
  static bool configured[kMaxBlockLog + 1] = {};
  switch (log_p) {
    case 9: *kernel = sriracha_block_kernel<Source, Probe, Key, 9>; break;
    case 10: *kernel = sriracha_block_kernel<Source, Probe, Key, 10>; break;
    case 11: *kernel = sriracha_block_kernel<Source, Probe, Key, 11>; break;
    case 12: *kernel = sriracha_block_kernel<Source, Probe, Key, 12>; break;
    case 13: *kernel = sriracha_block_kernel<Source, Probe, Key, 13>; break;
    default: *kernel = sriracha_block_kernel<Source, Probe, Key, 14>; break;
  }
  const int P = 1 << log_p;
  *smem = (size_t)(P + (P >> 4)) * sizeof(Key);
  if (configured[log_p]) return cudaSuccess;
  const cudaError_t err = allow_smem(*kernel, *smem);
  if (err == cudaSuccess) configured[log_p] = true;
  return err;
}

// One launch over all B rows of a batch of nwin windows a row, at P =
// 2^max(9, ceil(log2 min(nwin, 2^14))): one warp a row up to 512 windows
// (the words entry's narrow batches; the ASCII entry's rows that narrow
// take the warp kernel of sriracha.cu).
template <typename Source, typename Probe>
int launch_block(Source src, const void* lengths, Probe probe, void* out, int64_t B,
                 int64_t nwin, int64_t k, int64_t ns, int64_t out_stride, void* stream) {
  if (B < 0 || k < 1 || k > 32 || nwin < 1 || ns < 1 || out_stride < ns + 2 ||
      B > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int log_p = kMinBlockLog;
  while (log_p < kMaxBlockLog && (int64_t)1 << log_p < nwin) ++log_p;
  BlockKernel<Source, Probe> kernel;
  size_t smem;
  const cudaError_t err =
      k <= 16 ? block_kernel<Source, Probe, uint32_t>(log_p, &kernel, &smem)
              : block_kernel<Source, Probe, unsigned long long>(log_p, &kernel, &smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)B, (1 << log_p) >> kSlotLog, smem, (cudaStream_t)stream>>>(
      src, (const int32_t*)lengths, nwin, (int)k, probe, (int)ns, (int32_t*)out, out_stride);
  return (int)cudaGetLastError();
}

// The ASCII entry: rows of at most kMaxBlockWindows windows.
template <typename Probe>
int launch_block_ascii(const void* reads, const void* lengths, Probe probe, void* out,
                       int64_t B, int64_t L, int64_t k, int64_t ns, int64_t out_stride,
                       void* stream) {
  if (L - k + 1 > kMaxBlockWindows) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)reads & 15u) == 0 && (L & 15) == 0;
  return launch_block(AsciiSource{(const uint8_t*)reads, L, aligned}, lengths, probe, out, B,
                      L - k + 1, k, ns, out_stride, stream);
}

// The words entry: any nwin; rows of more than kMaxBlockWindows windows get
// zeros.
template <typename Probe>
int launch_block_words(const void* words, const void* valid, const void* lengths, Probe probe,
                       void* out, int64_t B, int64_t nwin, int64_t k, int64_t ns,
                       int64_t out_stride, void* stream) {
  return launch_block(WordsSource{(const int64_t*)words, (const uint8_t*)valid, nwin}, lengths,
                      probe, out, B, nwin, k, ns, out_stride, stream);
}

}  // namespace
