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
// Bound: bytes written. A window writes 9 bytes and reads k codes that its
// neighbours share (L1/L2 hits), so HBM traffic is the output.
//
// Design (simple and right first): one thread per window, grid-stride,
// 64-bit words in registers (no (hi, lo) split: the TPU's 32-bit lanes
// forced that, Hopper has native 64-bit integer registers). Neighbouring
// threads take neighbouring windows of one read, so output stores are
// coalesced and the input they read is the same few cache lines. The two
// layouts share the window loop (a template over the base reader); the
// ASCII one decodes on the card, so an ASCII tensor never visits the host.
// All offsets are int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct PackedBases {
  const uint32_t* packed;
  const uint32_t* validw;
  int64_t w16, w32;
  __device__ void get(int64_t r, int64_t pos, uint32_t& code, bool& ok) const {
    code = (packed[r * w16 + (pos >> 4)] >> (2 * (pos & 15))) & 3u;
    ok = ((validw[r * w32 + (pos >> 5)] >> (pos & 31)) & 1u) != 0;
  }
};

struct AsciiBases {
  const uint8_t* ascii;
  int64_t stride;
  __device__ void get(int64_t r, int64_t pos, uint32_t& code, bool& ok) const {
    // Setting bit 5 lower-cases a letter; the only bytes it maps to 'a'
    // are 'A' and 'a' (and likewise for c, g and t).
    const uint32_t c = ascii[r * stride + pos] | 0x20u;
    code = c == 'c' ? 1u : c == 'g' ? 2u : c == 't' ? 3u : 0u;
    ok = c == 'a' || c == 'c' || c == 'g' || c == 't';
  }
};

template <typename Bases>
__global__ void canonical_kmers_kernel(Bases bases, int64_t* __restrict__ words,
                                       uint8_t* __restrict__ valid, int64_t R,
                                       int64_t nwin, int k) {
  const int64_t total = R * nwin;
  const uint64_t sense_mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = t / nwin, j = t - r * nwin;
    uint64_t sense = 0, anti = 0;
    bool ok = true;
    for (int i = 0; i < k; ++i) {
      uint32_t code;
      bool base_ok;
      bases.get(r, j + i, code, base_ok);
      ok &= base_ok;
      sense = (sense << 2) | code;
      anti |= (uint64_t)(3u - code) << (2 * i);
    }
    sense &= sense_mask;
    words[t] = (int64_t)(sense <= anti ? sense : anti);
    valid[t] = ok;
  }
}

template <typename Bases>
int launch(Bases bases, void* words, void* valid, int64_t R, int64_t length,
           int64_t k, void* stream) {
  const int64_t nwin = length - k + 1;
  const int64_t total = R * nwin;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  canonical_kmers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      bases, (int64_t*)words, (uint8_t*)valid, R, nwin, (int)k);
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
