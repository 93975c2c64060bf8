// A variant of csrc/murmur.cu kept for measurement only; it is not part of
// the kernel library (kernels.build() takes csrc/*.cu alone).
//
//   python -m kwage_tpu_torch.kernels.time_kernel murmur \
//       kwage_tpu_torch/csrc/variants/murmur_k_only.cu
//
// The same function and decode, with k alone as a template parameter (32
// instances) and nh at run time: the seed loop is not unrolled and each
// seed's output is a 4-byte store.

#include <cstdint>
#include <utility>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxIndices = int64_t{1} << 31;  // n * nh below it: int32 indices

template <int K>
__global__ void __launch_bounds__(kThreads)
murmur32_kernel(const int64_t* __restrict__ words, uint32_t* __restrict__ out, int n, int nh,
                uint32_t mask) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    uint32_t blocks[(K + 3) / 4];
    kw::murmur_blocks_k<K>((uint64_t)__ldg(words + i), blocks);
    uint32_t* o = out + i * nh;
    for (int s = 0; s < nh; ++s) o[s] = kw::murmur_seed_k<K>(blocks, (uint32_t)s) & mask;
  }
}

using Kernel = void (*)(const int64_t*, uint32_t*, int, int, uint32_t);

template <int... K>
Kernel pick(int k, std::integer_sequence<int, K...>) {
  Kernel found = nullptr;
  ((k == K + 1 ? (found = murmur32_kernel<K + 1>, 0) : 0), ...);
  return found;
}

}  // namespace

extern "C" int kw_murmur32(const void* words, void* out, int64_t n, int64_t k,
                           int64_t nh, int64_t mask, void* stream) {
  if (n < 0 || n >= kMaxIndices || k < 1 || k > 32 || nh < 1 || nh >= kMaxIndices ||
      n * nh >= kMaxIndices)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Kernel kernel = pick((int)k, std::make_integer_sequence<int, 32>());
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)words, (uint32_t*)out, (int)n, (int)nh, (uint32_t)mask);
  return (int)cudaGetLastError();
}
