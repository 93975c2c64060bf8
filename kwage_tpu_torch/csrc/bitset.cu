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
// Bound: atomics into the image (one 4-byte atomicOr per (k-mer, seed)
// at a random address); at L <= 23 an image of 1 MiB or less sits in L2,
// above it every atomic is a DRAM sector read-modify-write.
//
// Design (simple and right first): one thread per sorted position,
// grid-stride. An unselected position costs one predicate and no atomic,
// so no compaction pass is needed (XLA paid its scatter for dropped
// rows). The bits go straight into packed words: no byte image, no pack
// pass. atomicOr is order-free, so the image is bit-identical from run to
// run. Word offsets are int64: num_acc * 2^L may pass 2^32 bits (the JAX
// version capped it at 2^31 and fell back per accession or to the host).

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bloom_set_bits_kernel(const int64_t* __restrict__ acc,
                                      const int64_t* __restrict__ words,
                                      const uint8_t* __restrict__ selected,
                                      const int32_t* __restrict__ slot_of_acc,
                                      uint32_t* __restrict__ out, int64_t n,
                                      int64_t num_acc, int k, int nh,
                                      uint32_t mask, int64_t wps) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (!selected[i]) continue;
    int64_t a = acc[i];
    if (a < 0 || a > num_acc) a = num_acc;
    const int64_t slot = slot_of_acc[a];
    if (slot < 0) continue;
    uint32_t blocks[kw::kMaxKmerBlocks];
    kw::murmur_blocks((uint64_t)words[i], k, blocks);
    uint32_t* image = out + slot * wps;
    for (int s = 0; s < nh; ++s) {
      const uint32_t bit = kw::murmur_seed(blocks, k, (uint32_t)s) & mask;
      atomicOr(image + (bit >> 5), 1u << (bit & 31));
    }
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
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  bloom_set_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)acc, (const int64_t*)words, (const uint8_t*)selected,
      (const int32_t*)slot_of_acc, (uint32_t*)out, n, num_acc, (int)k,
      (int)nh, mask, wps);
  return (int)cudaGetLastError();
}
