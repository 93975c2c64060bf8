// Packed bit-matrix transpose for the .db pack: filters -> bit slices.
//
// Replaces: kwage_tpu/ops/transpose.py _bt_pallas / _bt_kernel / _bt_body
// (the repo's Pallas kernel: 5 masked swap stages on 32-row blocks plus a
// word-block permute, in 4096 x 128-word VMEM blocks).
//
// Computes: x uint32 [F, W] (F % 32 == 0) -> out uint32 [W*32, F/32], bit
// (f, l) -> bit (l, f): out[32w + b, g] bit i == x[32g + i, w] bit b.
//
// Bound: bytes. One read and one write of the packed matrix and no
// arithmetic to speak of, so the H100's HBM bandwidth is the roof.
//
// Design (simple and right first): one warp per 32-row x 1-word tile. Lane
// i loads x[32g + i, w]; ballot b over the warp is exactly output word
// (32w + b, g), and lane b keeps it. The swap network and the TPU block
// shapes are not carried over. A block is 8 warps on 8 neighbouring words
// of the same 32 rows, so its loads use whole 32-byte sectors (through
// L1); blocks are ordered g-fastest, so the blocks that complete an output
// sector run side by side. Staging tiles in shared memory for fully
// coalesced 128-byte writes is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void bit_transpose_kernel(const uint32_t* __restrict__ x,
                                     uint32_t* __restrict__ out,
                                     int64_t F, int64_t W) {
  const int64_t G = F >> 5;                       // 32-row groups
  const int64_t g = blockIdx.x % G;
  const int64_t w = (blockIdx.x / G) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= W) return;                             // uniform per warp
  const uint32_t v = x[(g * 32 + lane) * W + w];  // 64-bit offsets
  uint32_t mine = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint32_t t = __ballot_sync(0xffffffffu, (v >> b) & 1u);
    if (lane == b) mine = t;
  }
  out[(w * 32 + lane) * G + g] = mine;
}

}  // namespace

extern "C" int kw_bit_transpose(const void* x, void* out, int64_t F,
                                int64_t W, void* stream) {
  if (F <= 0 || W <= 0 || (F & 31)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (F >> 5) * ((W + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bit_transpose_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, F, W);
  return (int)cudaGetLastError();
}

// Message for a code returned by any kw_* entry point of this library.
extern "C" const char* kw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
