// Bloom filter bit set: every selected k-mer's nh murmur bits, OR-ed into
// its accession's packed filter image.
//
// Replaces: tools/exp_pallas_bitset.py pallas_bitset (:74-85, kernel
// :51-72), the Pallas kernel that did out[ix >> 5] |= 1 << (ix & 31) one
// (1, 128)-lane row read-modify-write at a time in VMEM, and the XLA path
// the package kept instead: kwage_tpu/ops/counting.py set_filter_bits /
// set_filter_bits_multi (a scatter into a byte-per-bit image), the
// `compact` argsort before it (:276-281) and _pack_bit_image (:110-129).
//
// Computes: acc_s int64 [n], words_s int64 [n], selected uint8 [n],
// slot_of_acc int32 [num_acc + 1] (-1 drops the accession; index num_acc
// absorbs invalid windows) -> out uint32 [num_acc, wps], zeroed by the
// caller: for every selected i with slot s = slot_of_acc[acc_s[i]] >= 0
// and every seed h < nh, bit b = murmur3_32(words_s[i], h) & (2^L - 1)
// is set as bit b & 31 of out[s, b >> 5]. wps = max(1, 2^L / 32).
//
// Bound: integer operations (murmur over the selected words: ~350 for
// k = 31 and 4 seeds), then the atomics into the image (one 4-byte
// atomicOr per (k-mer, seed) at a random address; an image of a few MiB
// sits in L2). The flags are one byte a position; the pairs are read for
// the selected positions alone.
//
// Design: murmur on compacted positions. The first version ran one thread
// per position, so a warp paid the whole murmur whenever any of its 32
// lanes was selected (at the ingest's ~8% selected: 93% of warps, 8% of
// lanes busy). Now a block takes a tile of 16,384 positions, each thread
// reads its 64 flags as four 16-byte loads, and the block compacts the
// selected positions into shared memory (per-thread popcounts, then warp
// and block prefixes); then every thread of the block hashes one selected
// word at a time: slot_of_acc from shared memory, murmur_blocks once, the
// nh seeds, atomicOr. The order of the positions in the list does not
// matter: atomicOr is order-free, so the image is the same bits on every
// run. Word offsets are int64: num_acc * 2^L may pass 2^32 bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                     // flags a 16-byte load
constexpr int kChunks = 4;                     // 16-byte loads a thread and tile
constexpr int kTile = kChunks * kThreads * kChunk;   // positions a tile: 16384
constexpr int kSlotCap = 1024;                 // slot_of_acc entries staged
constexpr unsigned kFull = 0xffffffffu;

// Bits b of the result: byte b of `v` is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint4 v) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bits |= (uint32_t)(((x[q] >> (8 * b)) & 0xffu) != 0) << (4 * q + b);
  return bits;
}

__global__ void __launch_bounds__(kThreads)
bloom_set_bits_kernel(const int64_t* __restrict__ acc, const int64_t* __restrict__ words,
                      const uint8_t* __restrict__ selected,
                      const int32_t* __restrict__ slot_of_acc, uint32_t* __restrict__ out,
                      int64_t n, int64_t num_acc, int k, int nh, uint32_t mask, int64_t wps) {
  __shared__ uint16_t s_list[kTile];
  __shared__ uint32_t s_wsum[kWarps];
  __shared__ int32_t s_slot[kSlotCap];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool staged = num_acc < kSlotCap;
  if (staged)
    for (int j = t; j <= num_acc; j += kThreads) s_slot[j] = slot_of_acc[j];
  const bool aligned = ((uintptr_t)selected & 15) == 0;

  for (int64_t tile0 = (int64_t)blockIdx.x * kTile; tile0 < n;
       tile0 += (int64_t)gridDim.x * kTile) {
    // This thread's flags: 16 at tile0 + 4096 c + 16 t for each chunk c.
    uint64_t bits = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t start = tile0 + c * kThreads * kChunk + t * kChunk;
      uint32_t b16 = 0;
      if (aligned && start + kChunk <= n) {
        b16 = nonzero_bytes(*reinterpret_cast<const uint4*>(selected + start));
      } else {
        for (int b = 0; b < kChunk; ++b)
          if (start + b < n && selected[start + b]) b16 |= 1u << b;
      }
      bits |= (uint64_t)b16 << (16 * c);
    }
    // Compact: this thread's selected positions go to s_list[offset ...].
    const uint32_t count = __popcll(bits);
    uint32_t inc = count;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += up;
    }
    if (lane == 31) s_wsum[warp] = inc;
    __syncthreads();
    uint32_t offset = inc - count, total = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j < warp) offset += s_wsum[j];
      total += s_wsum[j];
    }
    while (bits) {
      const int q = __ffsll(bits) - 1;
      bits &= bits - 1;
      s_list[offset++] = (uint16_t)((q >> 4) * kThreads * kChunk + t * kChunk + (q & 15));
    }
    __syncthreads();

    // Hash: one selected position a thread at a time.
    for (uint32_t j = t; j < total; j += kThreads) {
      const int64_t i = tile0 + s_list[j];
      int64_t a = acc[i];
      const uint64_t word = (uint64_t)words[i];   // loaded beside the accession
      if (a < 0 || a > num_acc) a = num_acc;
      const int64_t slot = staged ? s_slot[a] : slot_of_acc[a];
      if (slot < 0) continue;
      uint32_t blocks[kw::kMaxKmerBlocks];
      kw::murmur_blocks(word, k, blocks);
      uint32_t* image = out + slot * wps;
      for (int s = 0; s < nh; ++s) {
        const uint32_t bit = kw::murmur_seed(blocks, k, (uint32_t)s) & mask;
        atomicOr(image + (bit >> 5), 1u << (bit & 31));
      }
    }
    __syncthreads();   // s_list and s_wsum are the next tile's
  }
}

}  // namespace

extern "C" int kw_bloom_set_bits(const void* acc, const void* words,
                                 const void* selected, const void* slot_of_acc,
                                 void* out, int64_t n, int64_t num_acc,
                                 int64_t k, int64_t nh, int64_t log2_len,
                                 int64_t wps, void* stream) {
  if (n < 0 || num_acc < 1 || k < 1 || k > 32 || nh < 1 || log2_len < 0 ||
      log2_len > 32 || wps * 32 < (1ll << log2_len))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const uint32_t mask = (uint32_t)((1ull << log2_len) - 1);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t grid = tiles < 8LL * sms ? tiles : 8LL * sms;
  bloom_set_bits_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)acc, (const int64_t*)words, (const uint8_t*)selected,
      (const int32_t*)slot_of_acc, (uint32_t*)out, n, num_acc, (int)k,
      (int)nh, mask, wps);
  return (int)cudaGetLastError();
}
