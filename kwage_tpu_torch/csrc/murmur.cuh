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

constexpr int kMaxKmerBlocks = 9;  // k <= 32: 8 full blocks + a tail

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// "ACGT"[code] for the base i (0-based from the 5' end) of a 2k-bit word.
__device__ __forceinline__ uint32_t base_ascii(uint64_t word, int k, int i) {
  const uint32_t code = (uint32_t)(word >> (2 * (k - 1 - i))) & 3u;
  return (0x54474341u >> (8 * code)) & 0xffu;  // bytes 'A' 'C' 'G' 'T'
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1b873593u;
}

// Seed-independent message words of one k-mer: blocks[0 .. k/4) are the
// full 4-byte blocks, blocks[k/4] the tail when k % 4 != 0.
__device__ __forceinline__ void murmur_blocks(uint64_t word, int k,
                                              uint32_t blocks[kMaxKmerBlocks]) {
  const int nblocks = k >> 2;
  for (int b = 0; b < nblocks; ++b) {
    uint32_t m = 0;
#pragma unroll
    for (int byte = 0; byte < 4; ++byte)
      m |= base_ascii(word, k, 4 * b + byte) << (8 * byte);
    blocks[b] = mix_k1(m);
  }
  if (k & 3) {
    uint32_t m = 0;
    for (int t = 0; t < (k & 3); ++t)
      m ^= base_ascii(word, k, 4 * nblocks + t) << (8 * t);
    blocks[nblocks] = mix_k1(m);
  }
}

__device__ __forceinline__ uint32_t murmur_seed(
    const uint32_t blocks[kMaxKmerBlocks], int k, uint32_t seed) {
  const int nblocks = k >> 2;
  uint32_t h = seed;
  for (int b = 0; b < nblocks; ++b) {
    h ^= blocks[b];
    h = rotl32(h, 13);
    h = h * 5u + 0xe6546b64u;
  }
  if (k & 3) h ^= blocks[nblocks];
  h ^= (uint32_t)k;  // the length: k bytes of ASCII
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

}  // namespace kw
