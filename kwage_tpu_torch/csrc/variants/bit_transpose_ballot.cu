// A variant of csrc/bit_transpose.cu kept for measurement only; it is not
// part of the kernel library (kernels.build() takes csrc/*.cu alone).
//
//   python -m kwage_tpu_torch.kernels.time_kernel bit_transpose \
//       kwage_tpu_torch/csrc/variants/bit_transpose_ballot.cu
//
// The same tile (8 row groups x 32 words through one shared-memory buffer,
// whole 128-byte row segments in, whole 32-byte sectors out), but the
// 32 x 32 bit transpose is the first version's: lane i holds row i of one
// word column, ballot b over the warp is output word b, lane b keeps it.
// A warp takes one row group and walks the tile's 32 word columns. The
// fill is 4-byte cp.async copies into rows of 33 words, so that the
// column reads (32 rows of one word) fall on 32 banks; the output goes
// back as O[w][b][g] with rows of 9 words for the same reason.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, GT = 8, WT = 32;
constexpr int kInStride = WT + 1, kOutStride = GT + 1;

__global__ void __launch_bounds__(kThreads)
bit_transpose_ballot(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     int64_t F, int64_t W, int64_t num_g_tiles) {
  __shared__ uint32_t buf[32 * WT * kOutStride];   // 9216 words >= 256 * 33
  const int64_t G = F >> 5;
  const int64_t g0 = (int64_t)(blockIdx.x % num_g_tiles) * GT;
  const int64_t w0 = (int64_t)(blockIdx.x / num_g_tiles) * WT;
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int64_t row0 = g0 * 32;

#pragma unroll
  for (int it = 0; it < 32 * GT * WT / kThreads; ++it) {
    const int c = it * kThreads + tid;
    const int r = c / WT, wl = c % WT;
    if (row0 + r < F && w0 + wl < W) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(buf + r * kInStride + wl);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(x + (row0 + r) * W + w0 + wl));
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  uint32_t mine[WT];
#pragma unroll
  for (int c = 0; c < WT; ++c) {
    const uint32_t v = buf[(32 * g + lane) * kInStride + c];
    mine[c] = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t t = __ballot_sync(0xffffffffu, (v >> b) & 1u);
      if (lane == b) mine[c] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < WT; ++c) buf[(c * 32 + lane) * kOutStride + g] = mine[c];
  __syncthreads();

#pragma unroll 8
  for (int it = 0; it < 32 * WT * GT / kThreads; ++it) {
    const int idx = it * kThreads + tid;
    const int og = idx % GT, rb = idx / GT;
    if (w0 + (rb >> 5) < W && g0 + og < G)
      out[(w0 * 32 + rb) * G + g0 + og] = buf[rb * kOutStride + og];
  }
}

}  // namespace

extern "C" int kw_bit_transpose(const void* x, void* out, int64_t F,
                                int64_t W, void* stream) {
  if (F <= 0 || W <= 0 || (F & 31)) return (int)cudaErrorInvalidValue;
  const int64_t g_tiles = ((F >> 5) + GT - 1) / GT;
  const int64_t blocks = g_tiles * ((W + WT - 1) / WT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bit_transpose_ballot<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, F, W, g_tiles);
  return (int)cudaGetLastError();
}
