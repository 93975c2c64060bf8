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
//
// Bound: 9 bytes read per window, then one random 4-byte LUT gather or one
// 96-byte bucket row (64 B keys, 32 B masks) per distinct word and group:
// latency-bound gathers (a 4^11 LUT, 16 MiB a group, sits in the 50 MB L2;
// a 4^14 one, 1 GiB, does not). subject_table: one atomicOr per word.
//
// Design (simple and right first): one block per read. The block compacts
// the read's valid words into shared memory (a shared counter hands out
// slots: the validity flag, never the word's value, decides what is kept),
// pads them with all-ones to the next power of two P and bitonic-sorts
// them there under unsigned 64-bit order, log2(P)(log2(P)+1)/2 passes with
// a barrier each and no global traffic (a 150 bp read sorts at most 256
// words, 2 KiB). The first n sorted slots are the n valid words whatever
// their values, so the k = 32 word -1 needs no special case. Distinct
// words (slots that differ from their left neighbour) are probed once per
// group; the set bits of each mask go to 32 shared counters by atomicAdd
// (integer, order-free: bit-exact run to run). All groups' tables are one
// allocation (LUT [G, 4^k]; hash rows concatenated with a first row and a
// bucket mask per group), so the sort runs once and one launch probes
// every group. Rows of more than 2^14 sort slots (128 KiB) sort in a
// global scratch slab that the wrapper allocates per row, in the same
// kernel (a 20 kbp read in a 32768 bucket: 256 KiB, in L2).
// All offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBucketCap = 8;
constexpr int64_t kMaxSharedWords = 1 << 14;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t hi, uint32_t lo) {
  uint32_t x = lo ^ (lo >> 16);
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  uint32_t y = hi ^ (hi >> 16);
  y *= 0x9E3779B1u;
  y ^= y >> 13;
  y *= 0x85EBCA6Bu;
  y ^= y >> 16;
  return x ^ y;
}

struct LutProbe {
  const uint32_t* table;  // [G, size]
  int64_t size;           // 4^k
  __device__ uint32_t operator()(int g, uint64_t w) const {
    return w < (uint64_t)size ? __ldg(table + g * size + (int64_t)w) : 0u;
  }
};

struct HashProbe {
  const unsigned long long* keys;  // [rows, kBucketCap]; empty slots all-ones
  const uint32_t* masks;  // [rows, kBucketCap]; empty slots 0
  const long long* row0;   // [G] first row of group g
  const long long* bmask;  // [G] 2^m_g - 1
  __device__ uint32_t operator()(int g, uint64_t w) const {
    const uint32_t b =
        mix32((uint32_t)(w >> 32), (uint32_t)w) & (uint32_t)bmask[g];
    const int64_t slot = (row0[g] + b) * kBucketCap;
    uint32_t m = 0;
#pragma unroll
    for (int c = 0; c < kBucketCap; ++c)
      if (keys[slot + c] == w) m |= __ldg(masks + slot + c);
    return m;
  }
};

template <typename Probe>
__global__ void sriracha_counts_kernel(const int64_t* __restrict__ words,
                                       const uint8_t* __restrict__ valid,
                                       const int32_t* __restrict__ lengths,
                                       int64_t nwin, int k, Probe probe, int ns,
                                       int32_t* __restrict__ out,
                                       int64_t out_stride, uint64_t* scratch,
                                       int64_t scratch_words) {
  extern __shared__ uint64_t smem[];
  __shared__ int n_valid, n_unique;
  __shared__ int cnt[32];
  const int64_t r = blockIdx.x;
  uint64_t* s = scratch != nullptr ? scratch + r * scratch_words : smem;
  if (threadIdx.x == 0) {
    n_valid = 0;
    n_unique = 0;
  }
  __syncthreads();

  // Compact the valid windows' words (slot order is arbitrary).
  const int64_t ends = (int64_t)lengths[r] - k + 1;  // windows j < ends fit the read
  const int64_t last = ends < nwin ? ends : nwin;
  const int64_t* wr = words + r * nwin;
  const uint8_t* vr = valid + r * nwin;
  for (int64_t j = threadIdx.x; j < last; j += blockDim.x)
    if (vr[j]) s[atomicAdd(&n_valid, 1)] = (uint64_t)wr[j];
  __syncthreads();
  const int n = n_valid;
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + threadIdx.x; i < P; i += blockDim.x) s[i] = ~0ull;
  __syncthreads();

  // Bitonic sort of s[0, P), unsigned.
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint64_t a = s[i], b = s[j];
        if ((a > b) == ((i & size) == 0)) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
  }

  int local = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    local += (i == 0 || s[i] != s[i - 1]);
  if (local) atomicAdd(&n_unique, local);

  for (int s0 = 0, g = 0; s0 < ns; s0 += 32, ++g) {
    const int nsg = ns - s0 < 32 ? ns - s0 : 32;
    if (threadIdx.x < 32) cnt[threadIdx.x] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
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
    if (threadIdx.x < nsg) out[r * out_stride + s0 + threadIdx.x] = cnt[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    out[r * out_stride + ns] = n;
    out[r * out_stride + ns + 1] = n_unique;
  }
}

int64_t next_pow2(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename Probe>
int launch_counts(const void* words, const void* valid, const void* lengths,
                  Probe probe, void* out, void* scratch, int64_t B,
                  int64_t nwin, int64_t k, int64_t ns, int64_t out_stride,
                  int64_t scratch_words, void* stream) {
  const int64_t P = next_pow2(nwin);
  if (B < 0 || nwin < 1 || k < 1 || k > 32 || ns < 1 || out_stride < ns + 2 ||
      P > (int64_t)1 << 30 ||
      (scratch == nullptr ? P > kMaxSharedWords : scratch_words < P))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static bool configured = false;  // per Probe
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sriracha_counts_kernel<Probe>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kMaxSharedWords * sizeof(uint64_t)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int threads = (int)(P / 2 < 64 ? 64 : P / 2 > kThreads ? kThreads : P / 2);
  const size_t smem = scratch == nullptr ? (size_t)P * sizeof(uint64_t) : 0;
  sriracha_counts_kernel<Probe><<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)words, (const uint8_t*)valid, (const int32_t*)lengths,
      nwin, (int)k, probe, (int)ns, (int32_t*)out, out_stride,
      (uint64_t*)scratch, scratch_words);
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

// (words, valid, lengths, table, out, scratch, B, nwin, k, size, ns,
//  out_stride, scratch_words, stream); scratch may be null (shared memory).
extern "C" int kw_sriracha_counts_lut(const void* words, const void* valid,
                                      const void* lengths, const void* table,
                                      void* out, void* scratch, int64_t B,
                                      int64_t nwin, int64_t k, int64_t size,
                                      int64_t ns, int64_t out_stride,
                                      int64_t scratch_words, void* stream) {
  if (size < 1) return (int)cudaErrorInvalidValue;
  return launch_counts(words, valid, lengths,
                       LutProbe{(const uint32_t*)table, size}, out, scratch, B,
                       nwin, k, ns, out_stride, scratch_words, stream);
}

// (words, valid, lengths, keys, masks, row0, bmask, out, scratch, B, nwin,
//  k, ns, out_stride, scratch_words, stream)
extern "C" int kw_sriracha_counts_hash(const void* words, const void* valid,
                                       const void* lengths, const void* keys,
                                       const void* masks, const void* row0,
                                       const void* bmask, void* out,
                                       void* scratch, int64_t B, int64_t nwin,
                                       int64_t k, int64_t ns,
                                       int64_t out_stride,
                                       int64_t scratch_words, void* stream) {
  return launch_counts(words, valid, lengths,
                       HashProbe{(const unsigned long long*)keys,
                                 (const uint32_t*)masks,
                                 (const long long*)row0,
                                 (const long long*)bmask},
                       out, scratch, B, nwin, k, ns, out_stride, scratch_words,
                       stream);
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
