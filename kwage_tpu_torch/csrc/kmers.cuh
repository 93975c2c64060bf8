// Canonical k-mer words from ASCII bases: the decode, the 2-bit packing and
// the window word, shared by kmers.cu (canonical_kmers, one word a window
// into device memory) and sriracha.cu (sriracha_reads, the words kept in
// registers), so the two cannot disagree.
//
// Replaces: the per-element bodies of kwage_tpu/ops/kmers.py
// encode_bases_device and _canonical_from_codes (XLA fusions on the TPU).
//
// Bound: integer operations. A base costs about 8 to decode and a quarter
// of a 16-base pack; a window, given its read's packed words, about twenty
// (two funnel shifts, a 64-bit bit reversal, a minimum) at every k.
//
// Design: a base is one byte ``code | ok << 2`` (A/C/G/T in either case
// are the codes 0-3 and ok; any other byte is code 0, not ok); 16 such
// bytes, read as four 32-bit words, pack into one word of 2-bit codes,
// LSB-first, and 16 ok bits. With the codes LSB-first, the 2k-bit slice s
// of the packed stream at bit 2j IS window j's reverse complement up to a
// NOT: anti = ~s & mask; the sense word is s with its bit pairs in reverse
// order (reverse all 64 bits, swap the two bits of each pair, shift right
// by 64 - 2k). The canonical word is the unsigned minimum of the two, and
// the window is valid iff the k ok bits at bit j of the validity stream
// are all set.

#pragma once

#include <cstdint>

namespace kw {

// One ASCII byte -> code | ok << 2. Setting bit 5 lower-cases a letter; the
// only bytes it maps to 'a' are 'A' and 'a' (and likewise for c, g and t).
__device__ __forceinline__ uint32_t base_code(uint32_t byte) {
  const uint32_t c = byte | 0x20u;
  const uint32_t code = c == 'c' ? 1u : c == 'g' ? 2u : c == 't' ? 3u : 0u;
  const bool ok = c == 'a' || c == 'c' || c == 'g' || c == 't';
  return code | (ok ? 4u : 0u);
}

// 16 bases of base_code bytes (q[0] holds the first four, LSB first) -> the
// packed word of their codes and their 16 ok bits: the code bits of a
// word's four bytes gather into 8 bits, their ok bits into 4.
__device__ __forceinline__ void pack16(const uint32_t q[4], uint32_t& codes,
                                       uint32_t& ok) {
  codes = 0;
  ok = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t x = q[t];
    const uint32_t c = x & 0x03030303u;
    codes |= ((c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xFFu) << (8 * t);
    const uint32_t o = (x >> 2) & 0x01010101u;
    ok |= ((o | (o >> 7) | (o >> 14) | (o >> 21)) & 0xFu) << (4 * t);
  }
}

// Swap the two bits of every pair.
__device__ __forceinline__ uint32_t swap_pairs(uint32_t x) {
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// The masks of one k: the word's 2k bits (lo, hi halves), the window's k
// ok bits, the sense word's shift after the reversal.
struct KmerShape {
  uint32_t mask_lo, mask_hi, kmask;
  int down;
  __device__ explicit KmerShape(int k) {
    const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    mask_lo = (uint32_t)mask;
    mask_hi = (uint32_t)(mask >> 32);
    kmask = k == 32 ? ~0u : (1u << k) - 1;
    down = 64 - 2 * k;
  }
};

// The canonical word of the window at base 16 p + sh / 2, from the packed
// words p, p + 1 and p + 2 (w0, w1, w2).
__device__ __forceinline__ uint64_t canonical_word(uint32_t w0, uint32_t w1, uint32_t w2,
                                                   int sh, const KmerShape& ks) {
  const uint32_t s_lo = __funnelshift_r(w0, w1, sh) & ks.mask_lo;
  const uint32_t s_hi = __funnelshift_r(w1, w2, sh) & ks.mask_hi;
  const uint64_t anti = ((uint64_t)(s_hi ^ ks.mask_hi) << 32) | (s_lo ^ ks.mask_lo);
  const uint64_t rev = ((uint64_t)swap_pairs(__brev(s_lo)) << 32) | swap_pairs(__brev(s_hi));
  const uint64_t sense = rev >> ks.down;
  return sense <= anti ? sense : anti;
}

// Whether the k bases from bit ``bit`` of the validity words v0, v1 are
// all ok.
__device__ __forceinline__ bool window_ok(uint32_t v0, uint32_t v1, int bit,
                                          const KmerShape& ks) {
  return (__funnelshift_r(v0, v1, bit) & ks.kmask) == ks.kmask;
}

}  // namespace kw
