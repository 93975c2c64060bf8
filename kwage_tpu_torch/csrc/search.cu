// The two search reductions over a resident bit-sliced signature matrix.
//
// Replaces: kwage_tpu/ops/search.py complete_kernel / search_complete
// (threshold 1.0) and counts_kernel / search_counts (threshold < 1), and
// kwage_tpu/parallel/sharded_search.py _total_hits_kernel (one shard's
// share of the per-query totals), which XLA compiled on the TPU.
//
// Inputs: db uint32 [R, W] (R = 2^L slice rows, bit j of filter j in word
// j/32), idx int32 [nq, nk, nh] slice rows per k-mer and seed, valid
// bool [nq, nk] (false = padding k-mer).
//   complete: out uint32 [nq, W] = AND over valid k-mers of (AND over seeds
//             of db[idx[q,k,h], :]); padding k-mers count as all-ones.
//   counts:   out int32 [nq, W*32], out[q, 32w + b] = number of valid
//             k-mers whose seed-AND word w has bit b set; padding adds 0.
//   total_hits: tcount int32 [nq] (>= 1); out int32 [nq] += the number of
//             bit columns whose count (as above) is >= tcount[q]. The
//             caller zeroes out; the counts never reach HBM (the JAX
//             version writes [nq, W*32] of them and reduces that).
//
// Bound: bytes. Each k-mer gathers nh rows of W words and does a few
// integer operations per word, so the random row reads from HBM are the
// roof (nq * nk * nh * W * 4 bytes per call).
//
// Design (simple and right first): a block is 32 word columns x 8 k-mer
// slices. Thread (x, y) owns word column w = 32*blockIdx.x + x of query
// blockIdx.y and walks k-mers y, y+8, ...; a warp therefore reads 128
// contiguous bytes of each gathered row. The per-k-mer match word never
// leaves registers (the JAX version writes [nq, nk, W] to HBM). complete
// ANDs into one register; counts keeps 32 per-bit counters in registers.
// The 8 k-mer slices combine through shared memory, and counts writes its
// 32 x 32 output block with coalesced stores. total_hits is counts up to
// that store: the 8 slices' partial counts are summed first, then compared
// with the query's threshold, and the block adds one integer to out[q]
// (integer atomics: order-free, the same bits every run). Every offset
// into db is int64: at L=26 with one 2048-filter file R*W is 2^32 words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlices = 8;       // k-mer slices per block (threadIdx.y)
constexpr int kMaxGridY = 65535;

// AND over the nh seeds of k-mer k's rows at word column w.
__device__ __forceinline__ uint32_t seed_and(const uint32_t* __restrict__ db,
                                             const int32_t* __restrict__ ik,
                                             int64_t nh, int64_t W, int64_t w) {
  uint32_t m = db[(int64_t)ik[0] * W + w];
  for (int64_t h = 1; h < nh; ++h) m &= db[(int64_t)ik[h] * W + w];
  return m;
}

__global__ void search_complete_kernel(const uint32_t* __restrict__ db,
                                       const int32_t* __restrict__ idx,
                                       const uint8_t* __restrict__ valid,
                                       uint32_t* __restrict__ out, int64_t nq,
                                       int64_t nk, int64_t nh, int64_t W) {
  __shared__ uint32_t part[kSlices][32];
  const int x = threadIdx.x, y = threadIdx.y;
  const int64_t w = (int64_t)blockIdx.x * 32 + x;
  for (int64_t q = blockIdx.y; q < nq; q += gridDim.y) {
    uint32_t acc = 0xffffffffu;
    if (w < W) {
      const int32_t* iq = idx + q * nk * nh;
      const uint8_t* vq = valid + q * nk;
      for (int64_t k = y; k < nk; k += kSlices)
        if (vq[k]) acc &= seed_and(db, iq + k * nh, nh, W, w);
    }
    part[y][x] = acc;
    __syncthreads();
    if (y == 0 && w < W) {
#pragma unroll
      for (int j = 1; j < kSlices; ++j) acc &= part[j][x];
      out[q * W + w] = acc;
    }
    __syncthreads();
  }
}

__global__ void search_counts_kernel(const uint32_t* __restrict__ db,
                                     const int32_t* __restrict__ idx,
                                     const uint8_t* __restrict__ valid,
                                     int32_t* __restrict__ out, int64_t nq,
                                     int64_t nk, int64_t nh, int64_t W) {
  // Row stride 33 keeps the 32 lanes of a warp on distinct banks.
  __shared__ int32_t part[kSlices][32 * 33];
  const int x = threadIdx.x, y = threadIdx.y;
  const int64_t w0 = (int64_t)blockIdx.x * 32;
  const int64_t w = w0 + x;
  for (int64_t q = blockIdx.y; q < nq; q += gridDim.y) {
    int32_t cnt[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] = 0;
    if (w < W) {
      const int32_t* iq = idx + q * nk * nh;
      const uint8_t* vq = valid + q * nk;
      for (int64_t k = y; k < nk; k += kSlices) {
        if (!vq[k]) continue;
        const uint32_t m = seed_and(db, iq + k * nh, nh, W, w);
#pragma unroll
        for (int b = 0; b < 32; ++b) cnt[b] += (m >> b) & 1u;
      }
    }
#pragma unroll
    for (int b = 0; b < 32; ++b) part[y][x * 33 + b] = cnt[b];
    __syncthreads();
    // out[q, 32*w0 + j] for j = 32*(word in block) + bit: 1024 counts,
    // contiguous in the output row; 256 threads store 4 each, coalesced.
    const int t = y * 32 + x;
    for (int j = t; j < 32 * 32; j += 32 * kSlices) {
      const int wl = j >> 5, b = j & 31;
      if (w0 + wl >= W) continue;
      int32_t s = 0;
#pragma unroll
      for (int s_i = 0; s_i < kSlices; ++s_i) s += part[s_i][wl * 33 + b];
      out[q * W * 32 + w0 * 32 + j] = s;
    }
    __syncthreads();
  }
}

__global__ void search_total_hits_kernel(const uint32_t* __restrict__ db,
                                         const int32_t* __restrict__ idx,
                                         const uint8_t* __restrict__ valid,
                                         const int32_t* __restrict__ tcount,
                                         int32_t* __restrict__ out, int64_t nq,
                                         int64_t nk, int64_t nh, int64_t W) {
  __shared__ int32_t part[kSlices][32 * 33];
  __shared__ int32_t warp_hits[kSlices];
  const int x = threadIdx.x, y = threadIdx.y;
  const int64_t w0 = (int64_t)blockIdx.x * 32;
  const int64_t w = w0 + x;
  for (int64_t q = blockIdx.y; q < nq; q += gridDim.y) {
    int32_t cnt[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] = 0;
    if (w < W) {
      const int32_t* iq = idx + q * nk * nh;
      const uint8_t* vq = valid + q * nk;
      for (int64_t k = y; k < nk; k += kSlices) {
        if (!vq[k]) continue;
        const uint32_t m = seed_and(db, iq + k * nh, nh, W, w);
#pragma unroll
        for (int b = 0; b < 32; ++b) cnt[b] += (m >> b) & 1u;
      }
    }
#pragma unroll
    for (int b = 0; b < 32; ++b) part[y][x * 33 + b] = cnt[b];
    __syncthreads();
    // The block's 32 x 32 bit columns, 4 a thread: sum the slices FIRST,
    // then compare. A word column past W adds nothing.
    const int32_t need = tcount[q];
    const int t = y * 32 + x;
    int32_t hits = 0;
    for (int j = t; j < 32 * 32; j += 32 * kSlices) {
      const int wl = j >> 5, b = j & 31;
      if (w0 + wl >= W) continue;
      int32_t s = 0;
#pragma unroll
      for (int s_i = 0; s_i < kSlices; ++s_i) s += part[s_i][wl * 33 + b];
      hits += (s >= need) ? 1 : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) hits += __shfl_down_sync(0xffffffffu, hits, o);
    if (x == 0) warp_hits[y] = hits;
    __syncthreads();
    if (t == 0) {
      int32_t total = 0;
#pragma unroll
      for (int j = 0; j < kSlices; ++j) total += warp_hits[j];
      if (total) atomicAdd(out + q, total);
    }
    __syncthreads();  // part and warp_hits are rewritten for the next query
  }
}

int grid_check(int64_t nq, int64_t W, dim3* grid) {
  const int64_t gx = (W + 31) / 32;
  if (nq <= 0 || W <= 0 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *grid = dim3((unsigned)gx, (unsigned)(nq < kMaxGridY ? nq : kMaxGridY));
  return 0;
}

}  // namespace

extern "C" int kw_search_complete(const void* db, const void* idx,
                                  const void* valid, void* out, int64_t nq,
                                  int64_t nk, int64_t nh, int64_t W,
                                  void* stream) {
  dim3 grid;
  if (nh <= 0) return (int)cudaErrorInvalidValue;
  if (int err = grid_check(nq, W, &grid)) return err;
  search_complete_kernel<<<grid, dim3(32, kSlices), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)db, (const int32_t*)idx, (const uint8_t*)valid,
      (uint32_t*)out, nq, nk, nh, W);
  return (int)cudaGetLastError();
}

extern "C" int kw_search_counts(const void* db, const void* idx,
                                const void* valid, void* out, int64_t nq,
                                int64_t nk, int64_t nh, int64_t W,
                                void* stream) {
  dim3 grid;
  if (nh <= 0) return (int)cudaErrorInvalidValue;
  if (int err = grid_check(nq, W, &grid)) return err;
  search_counts_kernel<<<grid, dim3(32, kSlices), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)db, (const int32_t*)idx, (const uint8_t*)valid,
      (int32_t*)out, nq, nk, nh, W);
  return (int)cudaGetLastError();
}

extern "C" int kw_search_total_hits(const void* db, const void* idx,
                                    const void* valid, const void* tcount,
                                    void* out, int64_t nq, int64_t nk,
                                    int64_t nh, int64_t W, void* stream) {
  dim3 grid;
  if (nh <= 0) return (int)cudaErrorInvalidValue;
  if (int err = grid_check(nq, W, &grid)) return err;
  search_total_hits_kernel<<<grid, dim3(32, kSlices), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)db, (const int32_t*)idx, (const uint8_t*)valid,
      (const int32_t*)tcount, (int32_t*)out, nq, nk, nh, W);
  return (int)cudaGetLastError();
}
