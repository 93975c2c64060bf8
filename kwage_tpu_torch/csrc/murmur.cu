// Seed-vectorised murmur3-32 of canonical k-mer words, optionally masked to
// slice-row indices.
//
// Replaces: kwage_tpu/ops/hashing.py murmur32_device and
// slice_indices_device (XLA elementwise fusions on the TPU).
//
// Computes: words int64 [n] (2k-bit canonical words) -> out uint32 [n, nh],
// out[i, s] = murmur3_32(ASCII of words[i], seed s) & mask (mask is
// 0xffffffff for the plain hash, 2^L - 1 for slice indices).
//
// Bound: integer operations (murmur.cuh); the 8-byte read and nh 4-byte
// writes per k-mer are far below the card's bandwidth.
//
// Design (simple and right first): one thread per k-mer, grid-stride. The
// message blocks are computed once per k-mer and reused for every seed;
// a thread's nh outputs are contiguous, so a warp's stores cover one
// contiguous span of 32 * nh words.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void murmur32_kernel(const int64_t* __restrict__ words,
                                uint32_t* __restrict__ out, int64_t n, int k,
                                int nh, uint32_t mask) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t blocks[kw::kMaxKmerBlocks];
    kw::murmur_blocks((uint64_t)words[i], k, blocks);
    for (int s = 0; s < nh; ++s)
      out[i * nh + s] = kw::murmur_seed(blocks, k, (uint32_t)s) & mask;
  }
}

}  // namespace

extern "C" int kw_murmur32(const void* words, void* out, int64_t n, int64_t k,
                           int64_t nh, int64_t mask, void* stream) {
  if (n < 0 || k < 1 || k > 32 || nh < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  murmur32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)words, (uint32_t*)out, n, (int)k, (int)nh,
      (uint32_t)mask);
  return (int)cudaGetLastError();
}
