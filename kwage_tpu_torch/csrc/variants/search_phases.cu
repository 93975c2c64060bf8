// The search call's phases, measured apart: the gather of one seed's rows
// (gather1) and the gather of nh seeds with their AND (gather5_and), each
// folded to one word with XOR. Measurement only (bench/search_phases.py,
// bench/sorted_gather.py); not built into the kernel library.
//
// Replaces no TPU kernel. They are the counterparts of the phase functions
// of tools/bench_search_phases.py (p_gather1, p_gather5: a jnp gather, the
// seed AND of kwage_tpu/ops/search.py _gather_and_reduce_seeds, an XOR
// reduce), added so that search_complete's and search_counts' time can be
// split into its gather, its seed AND and its reduction on this card.
//
// Inputs: db uint32 [R, W], idx int32 [nq, nk, nh], valid bool [nq, nk]
// (search.cu's). Output: out uint32 [1] = XOR over the valid k-mers of
//   gather1:     every word of db[idx[q, k, 0], :];
//   gather5_and: every word of AND over h < nh of db[idx[q, k, h], :].
// XOR commutes, so the word is the same in any block order.
//
// Bound: bytes, as the searches: the rows the valid k-mers gather
// (nq * nk * W * 4 for gather1, that times nh for gather5_and).
//
// Design: search.cu's, unchanged up to where the searches merge. The grid
// is every (query, chunk of 32 k-mer positions, 128-word tile), tile
// fastest; a block stages its chunk's idx rows and compacts the valid
// positions with ballots (stage_chunk); warp j gathers compacted k-mers j,
// j + 8, j + 16, j + 24 with every row load in flight before the first use
// (gather, or gather_seed0 below for one seed of an nh-wide idx row). Then
// a thread XORs its 4 k-mers' 4 words, the warp XORs by shuffles, the
// block its 8 warps' words, and one thread a block does atomicXor into out
// (zeroed by the entry first). Only that fold differs from
// complete_chunks_kernel and counts_chunks_kernel.

#include "search.cu"

namespace {

// m[r] = this lane's 4 words of seed 0's row of the warp's r-th k-mer; 0
// past the chunk's nv valid ones. Every load is issued before any use.
template <bool VEC>
__device__ __forceinline__ void gather_seed0(uint32_t (&m)[kKmersPerWarp][4],
                                             const uint32_t* __restrict__ db,
                                             const int32_t* s_idx, const uint8_t* s_pos, int nv,
                                             int nh, int64_t W, int64_t w0, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < kKmersPerWarp; ++r) {
    const int s = r * kWarps + warp;
    if (s < nv) load_row<VEC>(m[r], db, s_idx[s_pos[s] * nh], W, w0, lane);
    else m[r][0] = m[r][1] = m[r][2] = m[r][3] = 0u;
  }
}

// SEED0: gather1 (seed 0 of each k-mer); else gather5_and (NH seeds ANDed,
// NH == 0: nh at run time). XOR-folds the chunk's words of the tile into
// out[0].
template <bool SEED0, int NH, bool VEC>
__global__ void __launch_bounds__(kThreads) fold_chunks_kernel(const Chunks c) {
  extern __shared__ int32_t s_idx[];  // the chunk's idx rows [kChunk][nh]
  __shared__ uint32_t s_mask[kChunk / 32];
  __shared__ uint8_t s_pos[kChunk];
  __shared__ uint32_t s_x[kWarps];
  const int nh = NH > 0 ? NH : (int)c.nh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Unit u = unit_of(c);
  const int nv = stage_chunk(c, u, nh, s_idx, s_mask, s_pos);
  if (nv == 0) return;

  uint32_t m[kKmersPerWarp][4];
  if constexpr (SEED0)
    gather_seed0<VEC>(m, c.db, s_idx, s_pos, nv, nh, c.W, u.w0, warp, lane);
  else
    gather<NH, VEC>(m, c.db, s_idx, s_pos, nv, nh, c.W, u.w0, warp, lane, 0u);
  uint32_t x = 0u;
#pragma unroll
  for (int r = 0; r < kKmersPerWarp; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) x ^= m[r][e];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, d);
  if (lane == 0) s_x[warp] = x;
  __syncthreads();
  if (t == 0) {
    uint32_t v = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v ^= s_x[w];
    if (v) atomicXor(static_cast<uint32_t*>(c.out), v);
  }
}

template <bool SEED0, bool VEC>
void launch_fold_vec(const Chunks& c, unsigned blocks, size_t smem, cudaStream_t st) {
#define KW_FOLD(NH) fold_chunks_kernel<SEED0, NH, VEC><<<blocks, kThreads, smem, st>>>(c)
  if constexpr (SEED0) {
    KW_FOLD(0);
  } else {
    switch (c.nh) {
      case 1: KW_FOLD(1); break;
      case 2: KW_FOLD(2); break;
      case 3: KW_FOLD(3); break;
      case 4: KW_FOLD(4); break;
      case 5: KW_FOLD(5); break;
      default: KW_FOLD(0); break;
    }
  }
#undef KW_FOLD
}

// out[0] = 0, then every chunk of every query folded into it.
template <bool SEED0>
int launch_fold(const void* db, const void* idx, const void* valid, void* out, int64_t nq,
                int64_t nk, int64_t nh, int64_t W, cudaStream_t st) {
  if (int err = search_args_check(nq, nh, W)) return err;
  if (cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t), st)) return (int)err;
  const int64_t tiles = tiles_of(W), chunks = (nk + kChunk - 1) / kChunk;
  if (chunks == 0) return (int)cudaGetLastError();
  if (tiles * chunks * nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Chunks c{(const uint32_t*)db, (const int32_t*)idx, (const uint8_t*)valid, out,
                 nk, nh, W, tiles, chunks};
  const unsigned blocks = (unsigned)(tiles * chunks * nq);
  const size_t smem = (size_t)kChunk * nh * sizeof(int32_t);
  if (W % 4 == 0 && ((uintptr_t)db & 15) == 0)
    launch_fold_vec<SEED0, true>(c, blocks, smem, st);
  else
    launch_fold_vec<SEED0, false>(c, blocks, smem, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Message for a code returned by any kw_* entry point of this library.
extern "C" const char* kw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// (db, idx, valid, out, nq, nk, nh, W, stream): out uint32 [1].
extern "C" int kw_gather1(const void* db, const void* idx, const void* valid, void* out,
                          int64_t nq, int64_t nk, int64_t nh, int64_t W, void* stream) {
  return launch_fold<true>(db, idx, valid, out, nq, nk, nh, W, (cudaStream_t)stream);
}

extern "C" int kw_gather5_and(const void* db, const void* idx, const void* valid, void* out,
                              int64_t nq, int64_t nk, int64_t nh, int64_t W, void* stream) {
  return launch_fold<false>(db, idx, valid, out, nq, nk, nh, W, (cudaStream_t)stream);
}
