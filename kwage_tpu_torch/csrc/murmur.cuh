// Murmur3-32 of a 2-bit canonical k-mer word, as the reference hashes it:
// over the decoded ASCII bases, 5' end first, for one seed.
//
// Replaces: the per-element body of kwage_tpu/ops/hashing.py
// murmur32_device (an XLA elementwise fusion on the TPU). Shared by
// murmur.cu (the murmur32 kernel) and bitset.cu (bloom_set_bits), so the
// two cannot disagree.
//
// Bound: integer operations and bytes alike. A k-mer reads an 8-byte word;
// its decode costs about 6.5 operations a message block of 4 bases, and
// each seed 3 a block and 10 for the finish (kernels/time_kernel.py
// murmur_ops).
//
// Design: murmur_blocks() computes the seed-independent message words
// (k1 after its two multiplies and rotate) once per k-mer into registers;
// murmur_seed() then runs only the seed-dependent state updates, the
// same split as the reference's AVX2 8-seed hash (hash.cpp:239-332).
// Unsigned 32-bit arithmetic throughout: it wraps as murmur needs.
// murmur_blocks_k<K>() / murmur_seed_k<K>() are the same two steps with k
// fixed at compile time (the murmur32 kernel, one instance a k): no guard
// on k is left, only the ceil(k/4) blocks a k-mer has are computed, and
// the decode takes two blocks at a time.

#pragma once

#include <cstdint>

namespace kw {

constexpr int kMaxKmerBlocks = 8;  // k <= 32: 8 full blocks, or 7 and a tail

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1b873593u;
}

// Seed-independent message words of one k-mer: blocks[0 .. k/4) are the
// full 4-byte blocks, blocks[k/4] the tail when k % 4 != 0. The word is
// shifted so that its 5' base fills the top two bits; block b's four 2-bit
// codes are then byte 7 - b, spread to four selector nibbles, and one byte
// permute maps them to "ACGT" (the message bytes, 5' base first). The loops
// run over the eight blocks a k <= 32 can have, with guards, so every
// index is a constant and the blocks stay in registers.
__device__ __forceinline__ void murmur_blocks(uint64_t word, int k,
                                              uint32_t blocks[kMaxKmerBlocks]) {
  const int nblocks = k >> 2;
  const uint64_t aligned = word << (64 - 2 * k);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t codes = (uint32_t)(aligned >> (56 - 8 * b)) & 0xffu;
    const uint32_t sel = ((codes >> 6) & 3u) | ((codes >> 4) & 3u) << 4 |
                         ((codes >> 2) & 3u) << 8 | (codes & 3u) << 12;
    uint32_t m = __byte_perm(0x54474341u, 0u, sel);  // bytes 'A' 'C' 'G' 'T'
    if (b == nblocks) m &= (1u << (8 * (k & 3))) - 1u;  // the tail's k % 4 bases
    blocks[b] = mix_k1(m);
  }
}

__device__ __forceinline__ uint32_t murmur_seed(
    const uint32_t blocks[kMaxKmerBlocks], int k, uint32_t seed) {
  const int nblocks = k >> 2;
  uint32_t h = seed;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < nblocks) {
      h ^= blocks[b];
      h = rotl32(h, 13);
      h = h * 5u + 0xe6546b64u;
    } else if (b == nblocks && (k & 3)) {
      h ^= blocks[b];
    }
  }
  h ^= (uint32_t)k;  // the length: k bytes of ASCII
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

// --- k fixed at compile time --------------------------------------------------

// ASCII bytes of a 4-base block, 5' base in byte 0, from its byte of the
// bit-reversed word (decode in murmur_blocks_k): a 2-bit field there holds
// the base's code with its two bits swapped, so A 0, G 1, C 2, T 3.
constexpr uint32_t kSwappedAscii = 0x54434741u;  // bytes 'A' 'G' 'C' 'T'

// The tail block's k % 4 bases (block b == k / 4), the rest of it zero.
template <int K>
__device__ __forceinline__ uint32_t keep_bases(int b, uint32_t m) {
  return (K & 3) && b == K / 4 ? m & ((1u << (8 * (K & 3))) - 1u) : m;
}

// murmur_blocks(word, K, blocks) with K a constant: blocks[0 .. ceil(K/4)).
// Reversing the word's bits puts base i (5' first) at bits 2i, 2i + 1 and
// block b in byte b; a byte permute zero-extends two blocks' bytes to 16
// bits each, two masked shifts spread their 2-bit fields to nibbles, and
// one byte permute a block maps the nibbles to ASCII.
template <int K>
__device__ __forceinline__ void murmur_blocks_k(uint64_t word, uint32_t (&blocks)[(K + 3) / 4]) {
  constexpr int kBlocks = (K + 3) / 4;
  const uint64_t r = __brevll(word) >> (64 - 2 * K);
#pragma unroll
  for (int b = 0; b < kBlocks; b += 2) {
    const uint32_t half = b < 4 ? (uint32_t)r : (uint32_t)(r >> 32);
    uint32_t s = __byte_perm(half, 0u, (b & 2) ? 0x4342u : 0x4140u);
    s = (s | (s << 4)) & 0x0f0f0f0fu;
    s = (s | (s << 2)) & 0x33333333u;
    blocks[b] = mix_k1(keep_bases<K>(b, __byte_perm(kSwappedAscii, 0u, s)));
    if (b + 1 < kBlocks)
      blocks[b + 1] = mix_k1(keep_bases<K>(b + 1, __byte_perm(kSwappedAscii, 0u, s >> 16)));
  }
}

// murmur_seed(blocks, K, seed) with K a constant.
template <int K>
__device__ __forceinline__ uint32_t murmur_seed_k(const uint32_t (&blocks)[(K + 3) / 4],
                                                  uint32_t seed) {
  uint32_t h = seed;
#pragma unroll
  for (int b = 0; b < K / 4; ++b) {
    const uint32_t x = h ^ blocks[b];
    h = __funnelshift_l(x, x, 13) * 5u + 0xe6546b64u;
  }
  if constexpr ((K & 3) != 0) h ^= blocks[K / 4];
  h ^= (uint32_t)K;  // the length: K bytes of ASCII
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

}  // namespace kw
