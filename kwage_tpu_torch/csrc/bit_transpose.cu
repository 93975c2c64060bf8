// Packed bit-matrix transpose for the .db pack: filters -> bit slices.
//
// Replaces: kwage_tpu/ops/transpose.py _bt_pallas / _bt_kernel / _bt_body
// (the repo's Pallas kernel: 5 masked swap stages on 32-row blocks plus a
// word-block permute, in 4096 x 128-word VMEM blocks).
//
// Computes: x uint32 [F, W] (F % 32 == 0) -> out uint32 [W*32, F/32], bit
// (f, l) -> bit (l, f): out[32w + b, g] bit i == x[32g + i, w] bit b.
//
// Bound: bytes. One read and one write of the packed matrix (8 bytes a
// word) against about 13 operations a word, so the H100's HBM bandwidth
// is the roof, and the design is about whole sectors and bytes in flight.
//
// Design: a block of 256 threads takes a tile of GT row groups x WT words
// (GT x WT = 256: 8 x 32 when F >= 256, down to 1 x 256 at F = 32) through
// ONE 32 KiB shared-memory buffer.
//   1. Fill: every row's segment of WT x 4 contiguous bytes (128 at
//      8 x 32) goes global -> shared as 16-byte cp.async copies, 8 lanes a
//      row, 8 copies in flight a thread and no register held for them.
//      When W is not a multiple of 4 words (or x is not 16-byte aligned)
//      the rows are not 16-byte aligned and the fill is 4-byte loads.
//   2. Thread (g, w) reads its 32 x 32 bit tile, rows 32g .. 32g+31 of
//      word w, into 32 registers (the lanes of a warp are 32 neighbouring
//      w: 32 banks, no padding needed) and transposes it there: the 5
//      masked swap stages of the TPU kernel, 16 register pairs a stage, no
//      shuffle and no ballot. (One warp ballot a word, the first
//      version's way, is about 4 operations a word a warp, 128 a tile
//      against 13 here, and alone would cost the whole byte bound.)
//   3. After a barrier the same buffer takes the output as O[b][g][w]
//      with a row stride of WT + 1 words. Thread (g, w) stores word b at
//      (b*GT + g)*(WT+1) + w: bank w, no conflict. The padding word is
//      for the read-out: a warp reads, for one w, 32/GT neighbouring b
//      times GT neighbouring g, bank (b*GT + g + w) % 32, all different;
//      without it every g of one w would fall on bank w.
//   4. Read-out: output row 32w + b gets its GT words as one contiguous
//      run (32 bytes, a whole sector, at GT = 8; with F = 32 the rows are
//      one word and a warp's 32 rows are 128 contiguous bytes). No output
//      sector is shared between blocks when F >= 256.
// About 33 KiB of shared memory and 256 threads a block: four to six
// blocks an SM, 128 KiB and more of loads in flight, so no ring is
// needed. Blocks are ordered g-fastest: the blocks that complete a
// 128-byte output line run side by side.
// Edges are masked in the kernel: any F % 32 == 0, any W >= 1; offsets
// are 64-bit.
// The first version's kernel stays for matrices of at most kSmallTiles
// 32 x 32 bit tiles (bit_transpose_small: one warp a tile, one word a
// lane, 32 ballots): there a call is a few microseconds of latency, a
// tile a thread leaves most of the card idle and the shorter chain is
// faster ([32, 32] words: 0.0017 against 0.0033 ms, [256, 256]: 0.0027
// against 0.0047; the tiled kernel leads from [512, 512], 0.0048 against
// 0.0055 ms; H100 80GB HBM3, 700 W, kernels/time_kernel.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// 32 x 32 bit transpose in registers, LSB first: a[b] bit i <- a[i] bit b.
// Stage j swaps bits [j, 2j) of a[k] with bits [0, j) of a[k + j] in every
// 2j-aligned block of bits and of words.
__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  uint32_t m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j != 0; j >>= 1) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if ((k & j) == 0) {
        const uint32_t t = ((a[k] >> j) ^ a[k + j]) & m;
        a[k + j] ^= t;
        a[k] ^= t << j;
      }
    }
    m ^= m << (j >> 1);
  }
}

template <int GT, int WT>
__global__ void __launch_bounds__(kThreads)
bit_transpose_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     int64_t F, int64_t W, int64_t num_g_tiles, int vec) {
  static_assert(GT * WT == kThreads && WT % 32 == 0 && 32 % GT == 0, "tile shape");
  constexpr int kRows = 32 * GT;          // input rows of the tile
  constexpr int kOutStride = WT + 1;      // see 3. above
  __shared__ __align__(16) uint32_t buf[32 * GT * kOutStride];

  const int64_t G = F >> 5;
  const int64_t g0 = (int64_t)(blockIdx.x % num_g_tiles) * GT;
  const int64_t w0 = (int64_t)(blockIdx.x / num_g_tiles) * WT;
  const int tid = threadIdx.x;
  const int64_t row0 = g0 * 32;

  // 1. Fill buf as [kRows][WT], row-wise.
  if (vec) {
    constexpr int kChunksPerRow = WT / 4;
#pragma unroll
    for (int it = 0; it < kRows * kChunksPerRow / kThreads; ++it) {
      const int c = it * kThreads + tid;
      const int r = c / kChunksPerRow, ch = c % kChunksPerRow;
      if (row0 + r < F && w0 + 4 * ch < W)
        cp_async16(buf + r * WT + 4 * ch, x + (row0 + r) * W + w0 + 4 * ch);
    }
    cp_async_wait_all();
  } else {
#pragma unroll
    for (int it = 0; it < kRows * WT / kThreads; ++it) {
      const int c = it * kThreads + tid;
      const int r = c / WT, wl = c % WT;
      if (row0 + r < F && w0 + wl < W) buf[c] = x[(row0 + r) * W + w0 + wl];
    }
  }
  __syncthreads();

  // 2. One 32 x 32 bit tile a thread, transposed in registers.
  const int w = tid % WT, g = tid / WT;
  uint32_t a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = buf[(32 * g + i) * WT + w];
  transpose32(a);
  __syncthreads();

  // 3. The same buffer as O[b][g][w], row stride WT + 1.
#pragma unroll
  for (int b = 0; b < 32; ++b) buf[(b * GT + g) * kOutStride + w] = a[b];
  __syncthreads();

  // 4. Output row 32(w0 + w) + b, words g0 .. g0 + GT - 1, contiguous.
#pragma unroll 8
  for (int it = 0; it < 32 * WT * GT / kThreads; ++it) {
    const int idx = it * kThreads + tid;
    const int og = idx % GT, rb = idx / GT;
    const int ow = rb >> 5, ob = rb & 31;
    if (w0 + ow < W && g0 + og < G)
      out[((w0 + ow) * 32 + ob) * G + g0 + og] = buf[(ob * GT + og) * kOutStride + ow];
  }
}

// The first version: one warp per 32-row x 1-word tile. Lane i loads
// x[32g + i, w]; ballot b over the warp is output word (32w + b, g), and
// lane b keeps it. A block is 8 warps on 8 neighbouring words.
constexpr int kSmallWarps = 8;
constexpr int64_t kSmallTiles = 4096;

__global__ void bit_transpose_small(const uint32_t* __restrict__ x,
                                    uint32_t* __restrict__ out, int64_t F, int64_t W) {
  const int64_t G = F >> 5;
  const int64_t g = blockIdx.x % G;
  const int64_t w = (blockIdx.x / G) * kSmallWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= W) return;                             // uniform per warp
  const uint32_t v = x[(g * 32 + lane) * W + w];
  uint32_t mine = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint32_t t = __ballot_sync(0xffffffffu, (v >> b) & 1u);
    if (lane == b) mine = t;
  }
  out[(w * 32 + lane) * G + g] = mine;
}

template <int GT>
int launch(const void* x, void* out, int64_t F, int64_t W, cudaStream_t stream) {
  constexpr int WT = kThreads / GT;
  const int64_t G = F >> 5;
  const int64_t g_tiles = (G + GT - 1) / GT;
  const int64_t blocks = g_tiles * ((W + WT - 1) / WT);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = (W % 4 == 0) && (((uintptr_t)x & 15) == 0);
  bit_transpose_kernel<GT, WT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const uint32_t*)x, (uint32_t*)out, F, W, g_tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kw_bit_transpose(const void* x, void* out, int64_t F,
                                int64_t W, void* stream) {
  if (F <= 0 || W <= 0 || (F & 31)) return (int)cudaErrorInvalidValue;
  const int64_t G = F >> 5;
  cudaStream_t st = (cudaStream_t)stream;
  if (G * W <= kSmallTiles) {
    const int64_t blocks = G * ((W + kSmallWarps - 1) / kSmallWarps);
    bit_transpose_small<<<(unsigned)blocks, 32 * kSmallWarps, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, F, W);
    return (int)cudaGetLastError();
  }
  if (G >= 8) return launch<8>(x, out, F, W, st);
  if (G >= 4) return launch<4>(x, out, F, W, st);
  if (G >= 2) return launch<2>(x, out, F, W, st);
  return launch<1>(x, out, F, W, st);
}

// Message for a code returned by any kw_* entry point of this library.
extern "C" const char* kw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
