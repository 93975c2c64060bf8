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
//     valid (acc, word) pairs that is at least min_count long;
//   num_valid int32 [num_acc] += number of selected positions of each
//     accession (zeroed by the caller).
//
// Bound: bytes. Each position reads its own pair, the one before and the
// one min_count-1 ahead (neighbouring threads share those lines, so HBM
// sees ~16 bytes in and 1 byte out per position).
//
// Design (simple and right first): one thread per position, grid-stride
// in whole warps. A run of length >= m holds the same pair at p + m - 1 --
// O(1) per position, no segment sum. The per-accession count is an
// integer atomicAdd, so num_valid is the same on every run. Positions are
// sorted by accession, so the selected lanes of a warp nearly always
// share one: __match_any_sync groups them and one lane adds the group's
// size. (One atomicAdd per selected position put ~18.7 M atomics on 14
// addresses at the ingest shape and ran slower than the plain version.)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void select_runs_kernel(const int64_t* __restrict__ acc,
                                   const int64_t* __restrict__ words,
                                   uint8_t* __restrict__ selected,
                                   int32_t* __restrict__ num_valid, int64_t n,
                                   int64_t num_acc, int64_t ahead) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // Every lane of a warp runs the same iterations (the warp's first
  // position decides), so the warp-wide match below sees all 32 lanes.
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

}  // namespace

extern "C" int kw_select_runs(const void* acc, const void* words,
                              void* selected, void* num_valid, int64_t n,
                              int64_t num_acc, int64_t min_count,
                              void* stream) {
  if (n < 0 || num_acc < 1 || min_count < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  select_runs_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)acc, (const int64_t*)words, (uint8_t*)selected,
      (int32_t*)num_valid, n, num_acc, min_count - 1);
  return (int)cudaGetLastError();
}
