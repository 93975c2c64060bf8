// Murmur3-32 of a 2-bit canonical k-mer word, as the reference hashes it:
// over the decoded ASCII bases, 5' end first, for one seed.
//
// Replaces: the per-element body of kwage_tpu/ops/hashing.py
// murmur32_device (an XLA elementwise fusion on the TPU). Shared by
// murmur.cu (the murmur32 kernel) and bitset.cu (bloom_set_bits), so the
// two cannot disagree.
//
// Bound: integer operations. A k-mer costs ceil(k/4) message blocks plus
// ~6 operations per block and seed; the word it reads is 8 bytes.
//
// Design: murmur_blocks() computes the seed-independent message words
// (k1 after its two multiplies and rotate) once per k-mer into registers;
// murmur_seed() then runs only the seed-dependent state updates, the
// same split as the reference's AVX2 8-seed hash (hash.cpp:239-332).
// Unsigned 32-bit arithmetic throughout: it wraps as murmur needs.

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

}  // namespace kw
