// Exact-count thresholding of (accession, word) runs after the sort.
//
// Replaces: the post-sort part of kwage_tpu/ops/counting.py
// _count_multi_core (:219-253) -- XLA fusions on the TPU: the shifted
// compares for run starts and for a run of at least min_count, then a
// cumsum plus num_acc binary searches for the per-accession totals.
//
// Computes: acc_s int64 [n] (accession id, num_acc for an invalid window)
// and words_s int64 [n], sorted so equal (acc, word) pairs are adjacent
// and invalid windows come last ->
//   selected uint8 [n]: 1 iff position p is the first of a run of equal
//     valid (acc, word) pairs that is at least min_count long, i.e. the
//     pair before p differs and the pair at p + min_count - 1 is equal;
//   num_valid int32 [num_acc] += number of selected positions of each
//     accession (the kernel adds; the caller zeroes).
//
// Bound: bytes, 17 a position (a 16-byte pair in, a 1-byte flag out)
// against about 10 operations.
//
// Design: a block of 256 threads takes a tile of 256 x kIpt = 2048
// consecutive positions (32 KiB of pairs) and walks tiles in a grid-stride
// loop; the grid is what the card holds resident.
//   1. Every pair is read from HBM once: a thread starts four 16-byte
//      loads an array (two positions a load, eight loads in flight) before
//      the first use and stages them in shared memory, with a halo of one
//      pair before the tile and min_count - 1 pairs after it. A ragged
//      last tile, or arrays that are not 16-byte aligned, load 8 bytes a
//      position.
//   2. Thread t then takes positions t, t + 256, ... of the tile: its
//      three pairs (own, before, ahead) come out of shared memory at
//      stride 1 across the warp, without bank conflicts.
//   3. Flags go to a byte array in shared memory and leave as one 8-byte
//      store a thread: 256 contiguous bytes a warp. The ragged tail is
//      written bytewise.
//   4. Counts: a thread counts its selected positions in a register. When
//      every selected position of the tile has the accession of the
//      tile's first position (one __syncthreads_and; true everywhere but
//      at the num_acc - 1 accession boundaries), the count is a warp
//      reduction, a shared-memory add a warp and ONE global atomicAdd a
//      tile. Only a tile that straddles a boundary walks its flags again
//      and groups equal accessions with __match_any_sync, which serves any
//      num_acc. Integer atomics: num_valid is the same on every run.
// The first version's kernel stays for two cases (select_runs_simple: one
// position a thread, neighbours through L1, a __match_any_sync a warp):
// fewer than kTiledMinN positions, where a call is a few microseconds of
// latency and its shorter chain is faster (n = 4096: 0.0018 against
// 0.0023 ms; the tiled kernel leads from n = 2^20, 0.0062 against
// 0.0068 ms; H100 80GB HBM3, 700 W, kernels/time_kernel.py), and a
// look-ahead of more than kHalo pairs, which would not fit the halo.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIpt = 8;                 // positions a thread and tile
constexpr int kTile = kThreads * kIpt;
constexpr int kHalo = 32;               // most look-ahead pairs staged after a tile
constexpr int64_t kTiledMinN = 1 << 20;

// Requires ahead <= kHalo.
__global__ void __launch_bounds__(kThreads)
select_runs_kernel(const int64_t* __restrict__ acc, const int64_t* __restrict__ words,
                   uint8_t* __restrict__ selected, int32_t* __restrict__ num_valid,
                   int64_t n, int64_t num_acc, int64_t ahead, int64_t num_tiles,
                   int aligned) {
  // Position tile_base + j lives at index j + 2 (16-byte aligned for the
  // vector stores), the pair before the tile at index 1, the halo after
  // it from index kTile + 2.
  __shared__ __align__(16) int64_t s_acc[kTile + 2 + kHalo];
  __shared__ __align__(16) int64_t s_words[kTile + 2 + kHalo];
  __shared__ __align__(8) uint8_t s_flag[kTile];
  __shared__ int s_count;

  const int tid = threadIdx.x;

  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t base = tile * kTile;
    const bool full = aligned && base + kTile <= n;
    if (tid == 0) s_count = 0;

    // 1. Stage the tile and its halo.
    if (full) {
      const longlong2* ga = reinterpret_cast<const longlong2*>(acc + base);
      const longlong2* gw = reinterpret_cast<const longlong2*>(words + base);
      longlong2 va[kIpt / 2], vw[kIpt / 2];
#pragma unroll
      for (int i = 0; i < kIpt / 2; ++i) {
        va[i] = __ldcs(ga + i * kThreads + tid);
        vw[i] = __ldcs(gw + i * kThreads + tid);
      }
#pragma unroll
      for (int i = 0; i < kIpt / 2; ++i) {
        reinterpret_cast<longlong2*>(s_acc + 2)[i * kThreads + tid] = va[i];
        reinterpret_cast<longlong2*>(s_words + 2)[i * kThreads + tid] = vw[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int j = i * kThreads + tid;
        if (base + j < n) {
          s_acc[j + 2] = acc[base + j];
          s_words[j + 2] = words[base + j];
        }
      }
    }
    if (tid == 0 && base > 0) {
      s_acc[1] = acc[base - 1];
      s_words[1] = words[base - 1];
    }
    if (tid >= 32 && tid < 32 + ahead && base + kTile + tid - 32 < n) {
      s_acc[kTile + 2 + tid - 32] = acc[base + kTile + tid - 32];
      s_words[kTile + 2 + tid - 32] = words[base + kTile + tid - 32];
    }
    __syncthreads();

    // 2. Flags, and this thread's count.
    const int64_t a0 = s_acc[2];
    int count = 0;
    bool uniform = true;
#pragma unroll
    for (int i = 0; i < kIpt; ++i) {
      const int j = i * kThreads + tid;
      const int64_t p = base + j;
      bool sel = false;
      if (p < n) {
        const int64_t a = s_acc[j + 2], w = s_words[j + 2];
        sel = a >= 0 && a < num_acc;
        if (sel && p > 0) sel = s_acc[j + 1] != a || s_words[j + 1] != w;
        if (sel && ahead > 0)
          sel = p + ahead < n && s_acc[j + 2 + ahead] == a && s_words[j + 2 + ahead] == w;
        count += sel;
        uniform = uniform && (!sel || a == a0);
      }
      s_flag[j] = sel;
    }
    const bool one_acc = __syncthreads_and(uniform);

    // 3. Flags out.
    if (full && ((uintptr_t)selected & 7) == 0) {
#pragma unroll
      for (int j = tid; j < kTile / 8; j += kThreads)
        reinterpret_cast<uint64_t*>(selected + base)[j] =
            reinterpret_cast<const uint64_t*>(s_flag)[j];
    } else {
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int j = i * kThreads + tid;
        if (base + j < n) selected[base + j] = s_flag[j];
      }
    }

    // 4. Counts.
    if (one_acc) {
      count = __reduce_add_sync(0xffffffffu, count);
      if ((tid & 31) == 0 && count) atomicAdd(&s_count, count);
    } else {
#pragma unroll
      for (int i = 0; i < kIpt; ++i) {
        const int j = i * kThreads + tid;
        const bool sel = s_flag[j];
        const int64_t a = sel ? s_acc[j + 2] : -1;
        const unsigned group = __match_any_sync(0xffffffffu, (unsigned long long)a);
        if (sel && (tid & 31) == __ffs(group) - 1) atomicAdd(num_valid + a, __popc(group));
      }
    }
    __syncthreads();  // s_count is whole; the buffers may be overwritten
    if (tid == 0 && s_count) atomicAdd(num_valid + a0, s_count);
  }
}

// The first version: one position a thread, grid-stride in whole warps.
// Every lane of a warp runs the same iterations (the warp's first position
// decides), so the warp-wide match sees all 32 lanes.
__global__ void select_runs_simple(const int64_t* __restrict__ acc,
                                   const int64_t* __restrict__ words,
                                   uint8_t* __restrict__ selected,
                                   int32_t* __restrict__ num_valid, int64_t n,
                                   int64_t num_acc, int64_t ahead) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p - lane < n;
       p += stride) {
    bool sel = false;
    int64_t a = -1;
    if (p < n) {
      a = acc[p];
      const int64_t w = words[p];
      sel = a >= 0 && a < num_acc;
      if (sel && p > 0) sel = acc[p - 1] != a || words[p - 1] != w;
      if (sel && ahead > 0)
        sel = p + ahead < n && acc[p + ahead] == a && words[p + ahead] == w;
      selected[p] = sel;
    }
    const unsigned group =
        __match_any_sync(0xffffffffu, (unsigned long long)(sel ? a : -1));
    if (sel && lane == __ffs(group) - 1) atomicAdd(num_valid + a, __popc(group));
  }
}

// As many blocks as stay resident, so that the grid-stride loop has no
// second wave (asked of the runtime once).
int resident_blocks(int* out) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, select_runs_kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    resident = sms * per_sm;
  }
  *out = resident;
  return 0;
}

}  // namespace

extern "C" int kw_select_runs(const void* acc, const void* words,
                              void* selected, void* num_valid, int64_t n,
                              int64_t num_acc, int64_t min_count,
                              void* stream) {
  if (n < 0 || num_acc < 1 || min_count < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // No run is longer than n: a larger look-ahead selects nothing either,
  // and p + ahead cannot overflow.
  const int64_t ahead = min_count - 1 < n ? min_count - 1 : n;
  if (n < kTiledMinN || ahead > kHalo) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
    select_runs_simple<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)acc, (const int64_t*)words, (uint8_t*)selected,
        (int32_t*)num_valid, n, num_acc, ahead);
    return (int)cudaGetLastError();
  }
  int resident = 0;
  if (int err = resident_blocks(&resident)) return err;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  const int aligned = (((uintptr_t)acc | (uintptr_t)words) & 15) == 0;
  select_runs_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)acc, (const int64_t*)words, (uint8_t*)selected,
      (int32_t*)num_valid, n, num_acc, ahead, tiles, aligned);
  return (int)cudaGetLastError();
}
