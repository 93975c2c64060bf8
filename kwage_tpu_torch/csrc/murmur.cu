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
// Bound: bytes, the 8-byte read and nh 4-byte writes a k-mer at 3.35 TB/s;
// the integer operations (murmur.cuh) over the two pipes' issue limit are a
// little below them. Most of the operations (LOP3, SHF, PRMT) issue to one
// ALU pipe, and that pipe alone takes about as long as the bytes.
//
// Design (for Hopper): one thread a k-mer, grid-stride. The kernel has k
// (1..32) and nh (1..8) as template parameters, one instance a pair, so
// every guard on k folds away, only the ceil(k/4) blocks a k-mer has are
// decoded (murmur_blocks_k, once a k-mer) and the nh seed chains are
// unrolled (murmur_seed_k); nh > 8 takes the instance with nh at run time.
// A thread's nh outputs go out in one 16-byte store a 4 seeds (nh % 4 == 0)
// or one 8-byte store a 2, else 4 bytes a seed, so the entry refuses an
// out that is not 16-byte aligned (a torch allocation always is). Indices
// are int32: the entry refuses n * nh >= 2^31. With nh at run time as well
// (csrc/variants/murmur_k_only.cu, 32 instances) the kernel is 5% slower
// on an H100 at 2^23 k-mers and 4 seeds, and as fast at entry()'s 226.

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNh = 8;                        // nh as a template parameter: 1 .. kMaxNh
constexpr int64_t kMaxIndices = int64_t{1} << 31;  // n * nh below it: int32 indices

// NH > 0: nh == NH; NH == 0: nh at run time.
template <int K, int NH>
__global__ void __launch_bounds__(kThreads)
murmur32_kernel(const int64_t* __restrict__ words, uint32_t* __restrict__ out, int n, int nh,
                uint32_t mask) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    uint32_t blocks[(K + 3) / 4];
    kw::murmur_blocks_k<K>((uint64_t)__ldg(words + i), blocks);
    if constexpr (NH > 0) {
      uint32_t h[NH];
#pragma unroll
      for (int s = 0; s < NH; ++s) h[s] = kw::murmur_seed_k<K>(blocks, (uint32_t)s) & mask;
      if constexpr (NH % 4 == 0) {
        uint4* o = reinterpret_cast<uint4*>(out + i * NH);
#pragma unroll
        for (int v = 0; v < NH / 4; ++v)
          o[v] = make_uint4(h[4 * v], h[4 * v + 1], h[4 * v + 2], h[4 * v + 3]);
      } else if constexpr (NH % 2 == 0) {
        uint2* o = reinterpret_cast<uint2*>(out + i * NH);
#pragma unroll
        for (int v = 0; v < NH / 2; ++v) o[v] = make_uint2(h[2 * v], h[2 * v + 1]);
      } else {
#pragma unroll
        for (int s = 0; s < NH; ++s) out[i * NH + s] = h[s];
      }
    } else {
      for (int s = 0; s < nh; ++s)
        out[i * nh + s] = kw::murmur_seed_k<K>(blocks, (uint32_t)s) & mask;
    }
  }
}

using Kernel = void (*)(const int64_t*, uint32_t*, int, int, uint32_t);

template <int K, int... NH>
Kernel pick_nh(int nh, std::integer_sequence<int, NH...>) {
  Kernel found = murmur32_kernel<K, 0>;
  ((nh == NH + 1 ? (found = murmur32_kernel<K, NH + 1>, 0) : 0), ...);
  return found;
}

// The instance for (k, nh); nh == 0: the one with nh at run time.
template <int... K>
Kernel pick(int k, int nh, std::integer_sequence<int, K...>) {
  Kernel found = nullptr;
  ((k == K + 1 ? (found = pick_nh<K + 1>(nh, std::make_integer_sequence<int, kMaxNh>()), 0)
               : 0),
   ...);
  return found;
}

}  // namespace

extern "C" int kw_murmur32(const void* words, void* out, int64_t n, int64_t k,
                           int64_t nh, int64_t mask, void* stream) {
  if (n < 0 || n >= kMaxIndices || k < 1 || k > 32 || nh < 1 || nh >= kMaxIndices ||
      n * nh >= kMaxIndices)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  if (n == 0) return 0;
  const Kernel kernel = pick((int)k, nh <= kMaxNh ? (int)nh : 0,
                             std::make_integer_sequence<int, 32>());
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)words, (uint32_t*)out, (int)n, (int)nh, (uint32_t)mask);
  return (int)cudaGetLastError();
}
