// Canonical k-mer words of reads, 2-bit packed or ASCII: one entry per
// window.
//
// Replaces: kwage_tpu/ops/kmers.py canonical_kmers_packed_device,
// unpack_reads_device and _canonical_from_codes, vmapped over the reads
// (kwage_tpu/ops/counting.py:200), and canonical_kmers_device with
// encode_bases_device for ASCII input -- XLA fusions on the TPU that unroll
// the rolling window into k vector passes over [R, L-k+1] uint32 pairs.
//
// Computes, for one of two input layouts:
//   packed: packed uint32 [R, w16] (16 bases a word, 2 bits each,
//           LSB-first) and valid_words uint32 [R, w32] (one bit a base);
//   ascii:  bytes uint8 [R, stride] (A/C/G/T in either case are the codes
//           0-3; any other byte is code 0 and invalid);
// -> words int64 [R, nwin] and valid uint8 [R, nwin], nwin = length - k + 1.
// words[r, j] is the unsigned minimum of the sense word
// sum_i code(j+i) << 2(k-1-i) and the reverse complement
// sum_i (3 - code(j+i)) << 2i; valid[r, j] is 1 iff all k bases are ACGT.
// The word is computed for invalid windows too (non-ACGT bases are code
// 0), exactly as the JAX version does.
//
// Bound: bytes written, 9 per window (the input is 1/36 of that packed,
// 1/9 ASCII). The first version read every window's k bases one at a time
// (2k loads, ~8k integer operations per window) and was instruction-bound
// at 5% of the byte bound.
//
// Design: a window is a 2k-bit slice of the read's packed bit stream. With
// the codes LSB-first, the slice s at bit 2j IS the reverse complement up
// to a NOT: anti = ~s & mask; and the sense word is s with its bit pairs in
// reverse order: reverse all 64 bits, swap the two bits of each pair, shift
// right by 64 - 2k. Validity is "k ones at bit j of the validity stream".
// So a window costs three shared-memory words, two funnel shifts and about
// twenty integer operations at every k. The decode, the packing and the
// window word are kmers.cuh's, shared with sriracha.cu's fused kernel. One warp takes a chunk of 256
// windows of one read: it stages the chunk's 18 packed and 9 validity words
// in shared memory (the ASCII entry first 2-bit packs its bytes there, with
// the same codes and validity rule: a byte per base as code | ok << 2, then
// lane l < 18 packs 16 of them four at a time, gathering the code bits of a
// 32-bit word's four bytes with three shifts), then lane l computes windows
// l, l+32, ... so each 8-byte store instruction writes 256 contiguous bytes. The
// validity bytes are collected in shared memory and leave as aligned 4-byte
// words (single bytes only at a chunk's unaligned ends). Chunks are spread
// over the grid's warps, fewer warps a block while the blocks would not
// cover the card's 132 SMs twice (a batch of 512 short reads is 512 chunks);
// all offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // at most: see launch()
constexpr int kChunk = 256;           // windows per warp step
constexpr int kPackedWords = 20;      // 18 used: (255 >> 4) + 2, rounded up
constexpr int kValidWords = 10;       // 9 used: (255 >> 5) + 1
constexpr int kStageBases = kChunk + 32;  // bases a chunk's windows cover

struct WarpStage {
  uint32_t packed[kPackedWords];
  uint32_t validw[kValidWords];
  uint8_t vout[kChunk + 8];           // validity bytes, shifted by the
                                      // output's misalignment (0..3)
  alignas(4) uint8_t bases[kStageBases];  // ASCII entry: code | ok << 2 per base
};

// Stage the packed and validity words of bases [base0, base0 + 288) of row r.
struct PackedBases {
  const uint32_t* packed;
  const uint32_t* validw;
  int64_t w16, w32;
  __device__ void stage(WarpStage& st, int64_t r, int64_t base0,
                        int64_t /*length*/, int lane) const {
    const int64_t p0 = base0 >> 4, v0 = base0 >> 5;  // base0 % 256 == 0
    if (lane < kPackedWords)
      st.packed[lane] = p0 + lane < w16 ? packed[r * w16 + p0 + lane] : 0u;
    if (lane < kValidWords)
      st.validw[lane] = v0 + lane < w32 ? validw[r * w32 + v0 + lane] : 0u;
  }
};

struct AsciiBases {
  const uint8_t* ascii;
  int64_t stride;
  __device__ void stage(WarpStage& st, int64_t r, int64_t base0, int64_t length,
                        int lane) const {
    const uint8_t* row = ascii + r * stride;
    for (int m = lane; m < kStageBases; m += 32) {
      st.bases[m] = (uint8_t)(base0 + m < length ? kw::base_code(row[base0 + m]) : 0u);
    }
    __syncwarp();
    // Lane l < 18 packs bases [16 l, 16 l + 16).
    uint32_t w = 0, v16 = 0;
    if (lane < kStageBases / 16)
      kw::pack16(reinterpret_cast<const uint32_t*>(st.bases) + 4 * lane, w, v16);
    const uint32_t up = __shfl_down_sync(0xFFFFFFFFu, v16, 1);
    if (lane < kPackedWords) st.packed[lane] = w;
    if (lane < 2 * kValidWords && (lane & 1) == 0) st.validw[lane >> 1] = v16 | (up << 16);
  }
};

template <typename Bases>
__global__ void canonical_kmers_kernel(Bases bases, int64_t* __restrict__ words,
                                       uint8_t* __restrict__ valid, int64_t R,
                                       int64_t length, int64_t nwin, int k) {
  __shared__ WarpStage stage[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  WarpStage& st = stage[warp];
  const int64_t chunks = (nwin + kChunk - 1) / kChunk;
  const int64_t items = R * chunks;
  const kw::KmerShape ks(k);
  const int sh = 2 * (lane & 15);       // bit offset of this lane's windows
  for (int64_t item = (int64_t)blockIdx.x * warps + warp; item < items;
       item += (int64_t)gridDim.x * warps) {
    // One chunk a read (reads of up to 256 windows) needs no division.
    const int64_t r = chunks == 1 ? item : item / chunks, c = item - r * chunks;
    const int64_t j0 = c * kChunk;      // first window, and first base
    const int n = (int)(nwin - j0 < kChunk ? nwin - j0 : kChunk);
    __syncwarp();                       // the previous chunk's reads are done
    bases.stage(st, r, j0, length, lane);
    int64_t* wout = words + r * nwin + j0;
    uint8_t* vout = valid + r * nwin + j0;
    const int a = (int)((uintptr_t)vout & 3u);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      const int jl = lane + 32 * i;
      if (jl < n) {
        const int p = jl >> 4;
        wout[jl] = (int64_t)kw::canonical_word(st.packed[p], st.packed[p + 1],
                                               st.packed[p + 2], sh, ks);
        const int q = jl >> 5;
        st.vout[a + jl] = kw::window_ok(st.validw[q], st.validw[q + 1], jl & 31, ks);
      }
    }
    __syncwarp();
    // Validity bytes [a, a + n) of the staging buffer go to the aligned
    // address vout - a: whole 4-byte groups as one word, the ends bytewise.
    uint8_t* gb = vout - a;
    const int groups = (a + n + 3) >> 2;
    for (int g = lane; g < groups; g += 32) {
      const int lo = 4 * g;
      if (lo >= a && lo + 4 <= a + n) {
        *reinterpret_cast<uint32_t*>(gb + lo) =
            *reinterpret_cast<const uint32_t*>(st.vout + lo);
      } else {
        const int b0 = lo > a ? lo : a, b1 = lo + 4 < a + n ? lo + 4 : a + n;
        for (int b = b0; b < b1; ++b) gb[b] = st.vout[b];
      }
    }
  }
}

template <typename Bases>
int launch(Bases bases, void* words, void* valid, int64_t R, int64_t length,
           int64_t k, void* stream) {
  const int64_t nwin = length - k + 1;
  if (R * nwin == 0) return 0;
  const int64_t items = R * ((nwin + kChunk - 1) / kChunk);
  int warps = kWarps;
  while (warps > 1 && items / warps < 2 * 132) warps >>= 1;
  const int64_t blocks = (items + warps - 1) / warps;
  const unsigned grid = (unsigned)(blocks < (1 << 16) ? blocks : (1 << 16));
  canonical_kmers_kernel<<<grid, 32 * warps, 0, (cudaStream_t)stream>>>(
      bases, (int64_t*)words, (uint8_t*)valid, R, length, nwin, (int)k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kw_canonical_kmers(const void* packed, const void* validw,
                                  void* words, void* valid, int64_t R,
                                  int64_t w16, int64_t w32, int64_t length,
                                  int64_t k, void* stream) {
  if (k < 1 || k > 32 || length < k || R < 0 || w16 * 16 < length ||
      w32 * 32 < length)
    return (int)cudaErrorInvalidValue;
  return launch(PackedBases{(const uint32_t*)packed, (const uint32_t*)validw,
                            w16, w32},
                words, valid, R, length, k, stream);
}

extern "C" int kw_canonical_kmers_ascii(const void* ascii, void* words,
                                        void* valid, int64_t R, int64_t stride,
                                        int64_t length, int64_t k,
                                        void* stream) {
  if (k < 1 || k > 32 || length < k || R < 0 || stride < length)
    return (int)cudaErrorInvalidValue;
  return launch(AsciiBases{(const uint8_t*)ascii, stride}, words, valid, R,
                length, k, stream);
}
