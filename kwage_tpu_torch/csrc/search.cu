// The search reductions over a resident bit-sliced signature matrix.
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
//             caller zeroes out; the counts go to a scratch the caller
//             gives (kw_search_scratch_words int32 words), never to the
//             caller (the JAX version returns [nq, W*32] and reduces it).
//
// Bound: bytes. Each k-mer gathers nh rows of W words and does a few
// integer operations per word, so the random row reads from HBM are the
// roof (nq * nk * nh * W * 4 bytes per call).
//
// Design (for Hopper; one decomposition for the three). A block that walks
// a query's k-mers in series runs a chain of dependent flag, index and row
// loads, a memory latency a k-mer (about 300 GB/s), and the longest query
// of a batch sets the time. So the k-mer axis is split over blocks: a
// block's unit is (query, column tile of kTileWords words, chunk of kChunk
// k-mer positions); the grid is every such unit, tile fastest (the tiles
// of a chunk read the same rows), so a 1024-k-mer query spreads over 32
// chunks.
//  - The block stages the chunk's idx rows in shared memory and compacts its
//    valid k-mers there (valid is a flag, not a prefix) with one ballot a 32
//    positions; a chunk with none leaves at once, without an atomic.
//  - Warp j gathers compacted k-mers j, j + 8, j + 16, j + 24: it issues all
//    their nh row loads before it uses one (nh a template parameter), 16
//    bytes a lane where W % 4 == 0 and db is 16-byte aligned (a warp reads
//    512 contiguous bytes of a row), else 4 bytes at four 128-byte strides.
//    A slot past the chunk's valid k-mers holds the merge's identity.
//  - search_complete: a warp ANDs its (up to 4) seed-AND words (a dead slot
//    is all-ones), the block ANDs its 8 warps' words through shared memory,
//    and one thread a word does atomicAnd into the output, which the entry
//    first sets to all-ones. AND commutes, so the bits are the same in any
//    block order; a query with no valid k-mer keeps the all-ones.
//  - search_counts: carry-save, as in the JAX counts_kernel: a warp adds its
//    (up to 4) seed-AND words (a dead slot is 0) into 3 bit planes a word,
//    the block adds the 8 warps' planes into 6 (a count <= 32), and only
//    then expands them to 32 integer counts a word, one bit a lane, added
//    into the output with integer atomics (order-free: the same bits on
//    every run). The entry zeroes the output first.
//  - search_total_hits adds the same partial counts into an int32 scratch
//    [nq, W*32] (0.5 MiB at W=512, nq=8: it stays in L2; the entry zeroes
//    it, kw_search_scratch_words gives its size); a second kernel, a block
//    a (query, tile), compares the complete counts with tcount[q] and adds
//    its hits to out[q]. (Letting the last chunk of a (query, tile) to
//    arrive do the compare, with an arrival counter and a fence a block,
//    was 4-6 us slower at R=2^22, W=512, 8 queries on an H100.)
// Every offset into db is int64: at L=26 with one 2048-filter file R*W is
// 2^32 words. The staged idx rows limit nh to kMaxNh.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                       // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKmersPerWarp = 4;                // k-mers whose rows a warp has in flight
constexpr int kChunk = kWarps * kKmersPerWarp;  // k-mer positions a block
constexpr int kTileWords = 128;                 // word columns a block, 4 a lane
constexpr int kWarpPlanes = 3;                  // a warp's counts: 0 .. kKmersPerWarp
constexpr int kPlanes = 6;                      // a block's counts: 0 .. kChunk
constexpr int kMaxNh = 16 * 1024 / (kChunk * 4);  // the staged idx rows: 16 KiB at most
static_assert(kChunk % 32 == 0 && kChunk <= 256, "a ballot a 32 positions, uint8 slots");
static_assert((1 << kWarpPlanes) > kKmersPerWarp && (1 << kPlanes) > kChunk,
              "the planes hold the largest count");
static_assert(kTileWords == 4 * 32 && kTileWords % kWarps == 0, "4 words a lane");

// One launch of the chunked kernels: its inputs, its output (complete:
// uint32 [nq, W]; counts: int32 [nq, W*32]) and its grid's shape.
struct Chunks {
  const uint32_t* db;
  const int32_t* idx;
  const uint8_t* valid;
  void* out;
  int64_t nk, nh, W, tiles, chunks;
};

// acc += x, both numbers in bit planes (plane j: bit j of 32 counts at once),
// ripple carry; acc has room for the sum.
template <int NA, int NX>
__device__ __forceinline__ void plane_add(uint32_t (&acc)[NA], const uint32_t (&x)[NX]) {
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const uint32_t a = acc[j], b = j < NX ? x[j] : 0u;
    acc[j] = a ^ b ^ carry;
    carry = (a & b) | (carry & (a ^ b));
  }
}

// This lane's 4 words of row `row` in the tile starting at word w0: words
// w0 + 4*lane .. +3 (VEC, one 16-byte load) or w0 + lane + 32*e; 0 past W.
template <bool VEC>
__device__ __forceinline__ void load_row(uint32_t (&v)[4], const uint32_t* __restrict__ db,
                                         int32_t row, int64_t W, int64_t w0, int lane) {
  const uint32_t* r = db + (int64_t)row * W + w0;
  if (VEC) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (w0 + 4 * lane < W) x = __ldg(reinterpret_cast<const uint4*>(r) + lane);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = w0 + lane + 32 * e < W ? __ldg(r + lane + 32 * e) : 0u;
  }
}

// m[r] = this lane's 4 seed-AND words of the warp's r-th k-mer (compacted
// slot r * kWarps + warp; `dead` past the chunk's nv valid ones). NH > 0:
// every row load of the warp's k-mers is issued before the first AND;
// NH == 0 (nh at run time): one round of loads a seed.
template <int NH, bool VEC>
__device__ __forceinline__ void gather(uint32_t (&m)[kKmersPerWarp][4],
                                       const uint32_t* __restrict__ db, const int32_t* s_idx,
                                       const uint8_t* s_pos, int nv, int nh, int64_t W,
                                       int64_t w0, int warp, int lane, uint32_t dead) {
  if constexpr (NH > 0) {
    uint32_t v[kKmersPerWarp][NH][4];
#pragma unroll
    for (int r = 0; r < kKmersPerWarp; ++r) {
      const int s = r * kWarps + warp;
      if (s < nv) {
#pragma unroll
        for (int h = 0; h < NH; ++h) load_row<VEC>(v[r][h], db, s_idx[s_pos[s] * NH + h], W, w0, lane);
      }
    }
#pragma unroll
    for (int r = 0; r < kKmersPerWarp; ++r) {
      const bool live = r * kWarps + warp < nv;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t a = dead;
        if (live) {
          a = v[r][0][e];
#pragma unroll
          for (int h = 1; h < NH; ++h) a &= v[r][h][e];
        }
        m[r][e] = a;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kKmersPerWarp; ++r) {
      const int s = r * kWarps + warp;
      if (s < nv) load_row<VEC>(m[r], db, s_idx[s_pos[s] * nh], W, w0, lane);
      else m[r][0] = m[r][1] = m[r][2] = m[r][3] = dead;
    }
    for (int h = 1; h < nh; ++h) {
      uint32_t v[kKmersPerWarp][4];
#pragma unroll
      for (int r = 0; r < kKmersPerWarp; ++r) {
        const int s = r * kWarps + warp;
        if (s < nv) load_row<VEC>(v[r], db, s_idx[s_pos[s] * nh + h], W, w0, lane);
      }
#pragma unroll
      for (int r = 0; r < kKmersPerWarp; ++r)
        if (r * kWarps + warp < nv)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[r][e] &= v[r][e];
    }
  }
}

// A block's unit: (query q, chunk from position k0, tile from word w0)
// from blockIdx.x, tile fastest (the tiles of a chunk read the same rows).
struct Unit {
  int64_t q, k0, w0;
};

__device__ __forceinline__ Unit unit_of(const Chunks& c) {
  int64_t b = blockIdx.x;
  const int64_t tile = b % c.tiles;
  b /= c.tiles;
  return {b / c.chunks, (b % c.chunks) * kChunk, tile * kTileWords};
}

// Stages unit u's idx rows [.. kChunk][nh] in s_idx and compacts its valid
// positions into s_pos, one ballot a 32 positions; returns how many are
// valid (the same in every thread of the block).
__device__ __forceinline__ int stage_chunk(const Chunks& c, const Unit& u, int nh,
                                           int32_t* s_idx, uint32_t* s_mask, uint8_t* s_pos) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n_here = (int)(c.nk - u.k0 < kChunk ? c.nk - u.k0 : kChunk);
  const int32_t* ic = c.idx + (u.q * c.nk + u.k0) * nh;
  for (int e = t; e < n_here * nh; e += kThreads) s_idx[e] = __ldg(ic + e);
  if (warp < kChunk / 32) {
    const int k = warp * 32 + lane;
    const uint32_t m = __ballot_sync(0xffffffffu, k < n_here && c.valid[u.q * c.nk + u.k0 + k]);
    if (lane == 0) s_mask[warp] = m;
  }
  __syncthreads();
  int nv = 0, before = 0;
#pragma unroll
  for (int j = 0; j < kChunk / 32; ++j) {
    const int n = __popc(s_mask[j]);
    before += j < warp ? n : 0;
    nv += n;
  }
  if (warp < kChunk / 32) {
    const uint32_t m = s_mask[warp];
    if ((m >> lane) & 1u) s_pos[before + __popc(m & ((1u << lane) - 1u))] = warp * 32 + lane;
  }
  __syncthreads();
  return nv;
}

// search_complete: ANDs the chunk's seed-AND words of the tile's columns
// into out uint32 [nq, W] (all-ones before).
template <int NH, bool VEC>
__global__ void __launch_bounds__(kThreads) complete_chunks_kernel(const Chunks c) {
  extern __shared__ int32_t s_idx[];  // the chunk's idx rows [kChunk][nh]
  __shared__ uint32_t s_mask[kChunk / 32];
  __shared__ uint8_t s_pos[kChunk];   // compacted valid positions in the chunk
  __shared__ __align__(16) uint32_t s_and[kWarps][kTileWords];
  const int nh = NH > 0 ? NH : (int)c.nh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Unit u = unit_of(c);
  const int nv = stage_chunk(c, u, nh, s_idx, s_mask, s_pos);
  if (nv == 0) return;

  uint32_t m[kKmersPerWarp][4];
  gather<NH, VEC>(m, c.db, s_idx, s_pos, nv, nh, c.W, u.w0, warp, lane, 0xffffffffu);
  uint32_t a[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a[e] = m[0][e];
#pragma unroll
    for (int r = 1; r < kKmersPerWarp; ++r) a[e] &= m[r][e];
  }
  if (VEC) {
    reinterpret_cast<uint4*>(s_and[warp])[lane] = make_uint4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) s_and[warp][lane + 32 * e] = a[e];
  }
  __syncthreads();
  if (t < kTileWords && u.w0 + t < c.W) {
    uint32_t x = s_and[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x &= s_and[w][t];
    if (x != 0xffffffffu) atomicAnd(static_cast<uint32_t*>(c.out) + u.q * c.W + u.w0 + t, x);
  }
}

// search_counts (and total_hits' first step): adds the chunk's counts of the
// tile's columns into counts int32 [nq, W*32] (zeroed before).
template <int NH, bool VEC>
__global__ void __launch_bounds__(kThreads) counts_chunks_kernel(const Chunks c) {
  extern __shared__ int32_t s_idx[];  // the chunk's idx rows [kChunk][nh]
  __shared__ uint32_t s_mask[kChunk / 32];
  __shared__ uint8_t s_pos[kChunk];   // compacted valid positions in the chunk
  __shared__ __align__(16) uint32_t s_planes[kWarps][kWarpPlanes][kTileWords];
  __shared__ uint32_t s_sum[kPlanes][kTileWords];
  const int nh = NH > 0 ? NH : (int)c.nh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Unit u = unit_of(c);
  const int64_t w0 = u.w0;
  int32_t* qcounts = static_cast<int32_t*>(c.out) + u.q * c.W * 32;
  const int nv = stage_chunk(c, u, nh, s_idx, s_mask, s_pos);
  if (nv == 0) return;

  uint32_t m[kKmersPerWarp][4];
  gather<NH, VEC>(m, c.db, s_idx, s_pos, nv, nh, c.W, w0, warp, lane, 0u);
  uint32_t p[4][kWarpPlanes];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int j = 0; j < kWarpPlanes; ++j) p[e][j] = 0u;
#pragma unroll
    for (int r = 0; r < kKmersPerWarp; ++r) {
      const uint32_t x[1] = {m[r][e]};
      plane_add(p[e], x);
    }
  }
#pragma unroll
  for (int j = 0; j < kWarpPlanes; ++j) {
    if (VEC) {
      reinterpret_cast<uint4*>(s_planes[warp][j])[lane] =
          make_uint4(p[0][j], p[1][j], p[2][j], p[3][j]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_planes[warp][j][lane + 32 * e] = p[e][j];
    }
  }
  __syncthreads();
  if (t < kTileWords) {
    uint32_t sum[kPlanes];
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) sum[j] = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      uint32_t x[kWarpPlanes];
#pragma unroll
      for (int j = 0; j < kWarpPlanes; ++j) x[j] = s_planes[w][j][t];
      plane_add(sum, x);
    }
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) s_sum[j][t] = sum[j];
  }
  __syncthreads();
  // Expand: lane = bit, warp + kWarps*i = word of the tile; a warp adds 32
  // consecutive counts (one word's bits) a step.
#pragma unroll
  for (int i = 0; i < kTileWords / kWarps; ++i) {
    const int wl = warp + kWarps * i;
    int32_t n = 0;
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) n |= (int32_t)((s_sum[j][wl] >> lane) & 1u) << j;
    if (n && w0 + wl < c.W) atomicAdd(qcounts + (w0 + wl) * 32 + lane, n);
  }
}

// total_hits' compare: block (q, tile) adds the tile's columns whose count
// (complete: the chunks' kernel ran before) is >= tcount[q] to out[q].
__global__ void __launch_bounds__(kThreads)
search_hits_kernel(const int32_t* __restrict__ tcount, const int32_t* __restrict__ counts,
                   int32_t* __restrict__ out, int64_t W, int64_t tiles) {
  __shared__ int32_t s_hits[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t tile = blockIdx.x % tiles, q = blockIdx.x / tiles, w0 = tile * kTileWords;
  const int32_t* qcounts = counts + q * W * 32;
  const int32_t need = tcount[q];
  int hits = 0;
#pragma unroll
  for (int i = 0; i < kTileWords / kWarps; ++i) {
    const int64_t w = w0 + warp + kWarps * i;
    if (w < W) hits += qcounts[w * 32 + lane] >= need ? 1 : 0;
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0) s_hits[warp] = hits;
  __syncthreads();
  if (t == 0) {
    int32_t total = 0;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) total += s_hits[j];
    if (total) atomicAdd(out + q, total);
  }
}

int64_t tiles_of(int64_t W) { return (W + kTileWords - 1) / kTileWords; }

template <bool COMPLETE, bool VEC>
void launch_vec(const Chunks& c, unsigned blocks, size_t smem, cudaStream_t st) {
#define KW_CHUNKS(NH)                                                       \
  if constexpr (COMPLETE)                                                   \
    complete_chunks_kernel<NH, VEC><<<blocks, kThreads, smem, st>>>(c);     \
  else                                                                      \
    counts_chunks_kernel<NH, VEC><<<blocks, kThreads, smem, st>>>(c)
  switch (c.nh) {
    case 1: KW_CHUNKS(1); break;
    case 2: KW_CHUNKS(2); break;
    case 3: KW_CHUNKS(3); break;
    case 4: KW_CHUNKS(4); break;
    case 5: KW_CHUNKS(5); break;
    default: KW_CHUNKS(0); break;
  }
#undef KW_CHUNKS
}

// Every chunk of every query into out (set to the merge's identity before):
// COMPLETE, the AND of its seed-AND words; else its counts.
template <bool COMPLETE>
int launch_chunks(const void* db, const void* idx, const void* valid, void* out,
                  int64_t nq, int64_t nk, int64_t nh, int64_t W, cudaStream_t st) {
  const int64_t tiles = tiles_of(W), chunks = (nk + kChunk - 1) / kChunk;
  if (chunks == 0) return (int)cudaGetLastError();
  if (tiles * chunks * nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Chunks c{(const uint32_t*)db, (const int32_t*)idx, (const uint8_t*)valid, out,
                 nk, nh, W, tiles, chunks};
  const unsigned blocks = (unsigned)(tiles * chunks * nq);
  const size_t smem = (size_t)kChunk * nh * sizeof(int32_t);
  if (W % 4 == 0 && ((uintptr_t)db & 15) == 0)
    launch_vec<COMPLETE, true>(c, blocks, smem, st);
  else
    launch_vec<COMPLETE, false>(c, blocks, smem, st);
  return (int)cudaGetLastError();
}

int search_args_check(int64_t nq, int64_t nh, int64_t W) {
  return nq <= 0 || W <= 0 || nh <= 0 || nh > kMaxNh ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

extern "C" int kw_search_complete(const void* db, const void* idx,
                                  const void* valid, void* out, int64_t nq,
                                  int64_t nk, int64_t nh, int64_t W,
                                  void* stream) {
  if (int err = search_args_check(nq, nh, W)) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(out, 0xff, (size_t)(nq * W) * sizeof(uint32_t), st))
    return (int)err;
  return launch_chunks<true>(db, idx, valid, out, nq, nk, nh, W, st);
}

extern "C" int kw_search_counts(const void* db, const void* idx,
                                const void* valid, void* out, int64_t nq,
                                int64_t nk, int64_t nh, int64_t W,
                                void* stream) {
  if (int err = search_args_check(nq, nh, W)) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(nq * W * 32) * sizeof(int32_t), st))
    return (int)err;
  return launch_chunks<false>(db, idx, valid, out, nq, nk, nh, W, st);
}

// int32 words of scratch kw_search_total_hits takes: the counts [nq, W*32].
extern "C" int64_t kw_search_scratch_words(int64_t nq, int64_t W) { return nq * W * 32; }

extern "C" int kw_search_total_hits(const void* db, const void* idx,
                                    const void* valid, const void* tcount,
                                    void* out, void* scratch, int64_t nq, int64_t nk,
                                    int64_t nh, int64_t W, void* stream) {
  if (int err = search_args_check(nq, nh, W)) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = tiles_of(W);
  if (tiles * nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)kw_search_scratch_words(nq, W);
  if (cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(int32_t), st))
    return (int)err;
  if (int err = launch_chunks<false>(db, idx, valid, scratch, nq, nk, nh, W, st)) return err;
  search_hits_kernel<<<(unsigned)(tiles * nq), kThreads, 0, st>>>(
      (const int32_t*)tcount, (const int32_t*)scratch, (int32_t*)out, W, tiles);
  return (int)cudaGetLastError();
}
