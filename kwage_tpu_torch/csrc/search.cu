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
//             caller zeroes out; the counts go to a scratch the caller
//             gives (kw_search_scratch_words int32 words), never to the
//             caller (the JAX version returns [nq, W*32] and reduces it).
//
// Bound: bytes. Each k-mer gathers nh rows of W words and does a few
// integer operations per word, so the random row reads from HBM are the
// roof (nq * nk * nh * W * 4 bytes per call).
//
// Design of search_complete (simple and right first): a block is 32
// word columns x 8 k-mer slices. Thread (x, y) owns word column w =
// 32*blockIdx.x + x of query blockIdx.y and walks k-mers y, y+8, ...; a
// warp reads 128 contiguous bytes of each gathered row. The per-k-mer match
// word never leaves registers (the JAX version writes [nq, nk, W] to HBM);
// it ANDs into one register, and the 8 slices combine through shared memory.
//
// Design of search_counts and search_total_hits (for Hopper): with
// search_complete's design a (query, 32 columns) is ONE block that walks
// the query's k-mers in series, a chain of dependent index, flag and row
// loads, so a long query among short ones sets the time (a memory latency
// a k-mer, about 300 GB/s). So the k-mer axis is split over blocks too. A
// block's unit is (query, column tile of kTileWords words, chunk of kChunk
// k-mer positions); the grid is every such unit, so a 1024-k-mer query
// spreads over 32 chunks.
//  - The block stages the chunk's idx rows in shared memory and compacts its
//    valid k-mers there (valid is a flag, not a prefix) with one ballot a 32
//    positions; a chunk with none leaves at once.
//  - Warp j gathers compacted k-mers j, j + 8, j + 16, j + 24: it issues all
//    their nh row loads before it uses one (nh a template parameter), 16
//    bytes a lane where W % 4 == 0 and db is 16-byte aligned (a warp reads
//    512 contiguous bytes of a row), else 4 bytes at four 128-byte strides.
//  - Counting is carry-save, as in the JAX counts_kernel: a warp adds its
//    (up to 4) seed-AND words into 3 bit planes a word, the block adds the
//    8 warps' planes into 6 (a count <= 32), and only then expands them to
//    32 integer counts a word, one bit a lane, added into the output with
//    integer atomics (order-free: the same bits on every run). The entry
//    zeroes the output first.
//  - search_total_hits adds the same partial counts into an int32 scratch
//    [nq, W*32] (0.5 MiB at W=512, nq=8: it stays in L2; the entry zeroes
//    it, kw_search_scratch_words gives its size); a second kernel, a block
//    a (query, tile), compares the complete counts with tcount[q] and adds
//    its hits to out[q]. (Letting the last chunk of a (query, tile) to
//    arrive do the compare, with an arrival counter and a fence a block,
//    was 4-6 us slower at R=2^22, W=512, 8 queries on an H100.)
// Every offset into db is int64: at L=26 with one 2048-filter file R*W is
// 2^32 words.

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

// --- search_counts / search_total_hits: chunks of k-mers over blocks -------

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
// slot r * kWarps + warp; 0 past the chunk's nv valid ones). NH > 0: every
// row load of the warp's k-mers is issued before the first AND; NH == 0
// (nh at run time): one round of loads a seed.
template <int NH, bool VEC>
__device__ __forceinline__ void gather(uint32_t (&m)[kKmersPerWarp][4],
                                       const uint32_t* __restrict__ db, const int32_t* s_idx,
                                       const uint8_t* s_pos, int nv, int nh, int64_t W,
                                       int64_t w0, int warp, int lane) {
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
        uint32_t a = 0;
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
      else m[r][0] = m[r][1] = m[r][2] = m[r][3] = 0u;
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

// One block: (query q, tile, chunk) from blockIdx.x, tile fastest (the
// tiles of a chunk read the same rows). Adds the chunk's counts of the
// tile's columns into counts [nq, W*32].
template <int NH, bool VEC>
__global__ void __launch_bounds__(kThreads)
search_chunks_kernel(const uint32_t* __restrict__ db, const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ valid, int32_t* __restrict__ counts,
                     int64_t nk, int64_t nh_rt, int64_t W, int64_t tiles, int64_t chunks) {
  extern __shared__ int32_t s_idx[];  // the chunk's idx rows [kChunk][nh]
  __shared__ uint32_t s_mask[kChunk / 32];
  __shared__ uint8_t s_pos[kChunk];   // compacted valid positions in the chunk
  __shared__ __align__(16) uint32_t s_planes[kWarps][kWarpPlanes][kTileWords];
  __shared__ uint32_t s_sum[kPlanes][kTileWords];
  const int nh = NH > 0 ? NH : (int)nh_rt;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int64_t b = blockIdx.x;
  const int64_t tile = b % tiles;
  b /= tiles;
  const int64_t chunk = b % chunks, q = b / chunks;
  const int64_t k0 = chunk * kChunk;
  const int n_here = (int)(nk - k0 < kChunk ? nk - k0 : kChunk);
  const int64_t w0 = tile * kTileWords;
  int32_t* qcounts = counts + q * W * 32;

  const int32_t* ic = idx + (q * nk + k0) * nh;
  for (int e = t; e < n_here * nh; e += kThreads) s_idx[e] = __ldg(ic + e);
  if (warp < kChunk / 32) {
    const int k = warp * 32 + lane;
    const uint32_t m = __ballot_sync(0xffffffffu, k < n_here && valid[q * nk + k0 + k]);
    if (lane == 0) s_mask[warp] = m;
  }
  __syncthreads();
  int nv = 0, before = 0;
#pragma unroll
  for (int j = 0; j < kChunk / 32; ++j) {
    const int c = __popc(s_mask[j]);
    before += j < warp ? c : 0;
    nv += c;
  }
  if (warp < kChunk / 32) {
    const uint32_t m = s_mask[warp];
    if ((m >> lane) & 1u) s_pos[before + __popc(m & ((1u << lane) - 1u))] = warp * 32 + lane;
  }
  __syncthreads();

  if (nv > 0) {
    uint32_t m[kKmersPerWarp][4];
    gather<NH, VEC>(m, db, s_idx, s_pos, nv, nh, W, w0, warp, lane);
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
      int32_t c = 0;
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) c |= (int32_t)((s_sum[j][wl] >> lane) & 1u) << j;
      if (c && w0 + wl < W) atomicAdd(qcounts + (w0 + wl) * 32 + lane, c);
    }
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

template <bool VEC>
void launch_chunks_vec(int64_t nh, unsigned blocks, size_t smem, cudaStream_t st,
                       const uint32_t* db, const int32_t* idx, const uint8_t* valid,
                       int32_t* counts, int64_t nk, int64_t W, int64_t tiles, int64_t chunks) {
#define KW_CHUNKS(NH)                                                            \
  search_chunks_kernel<NH, VEC><<<blocks, kThreads, smem, st>>>(                 \
      db, idx, valid, counts, nk, nh, W, tiles, chunks)
  switch (nh) {
    case 1: KW_CHUNKS(1); break;
    case 2: KW_CHUNKS(2); break;
    case 3: KW_CHUNKS(3); break;
    case 4: KW_CHUNKS(4); break;
    case 5: KW_CHUNKS(5); break;
    default: KW_CHUNKS(0); break;
  }
#undef KW_CHUNKS
}

// counts [nq, W*32] (zeroed before) += every chunk's counts.
int launch_chunks(const void* db, const void* idx, const void* valid, void* counts,
                  int64_t nq, int64_t nk, int64_t nh, int64_t W, cudaStream_t st) {
  const int64_t tiles = tiles_of(W), chunks = (nk + kChunk - 1) / kChunk;
  if (chunks == 0) return (int)cudaGetLastError();
  if (tiles * chunks * nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(tiles * chunks * nq);
  const size_t smem = (size_t)kChunk * nh * sizeof(int32_t);
  const bool vec = W % 4 == 0 && ((uintptr_t)db & 15) == 0;
  if (vec)
    launch_chunks_vec<true>(nh, blocks, smem, st, (const uint32_t*)db, (const int32_t*)idx,
                            (const uint8_t*)valid, (int32_t*)counts, nk, W, tiles, chunks);
  else
    launch_chunks_vec<false>(nh, blocks, smem, st, (const uint32_t*)db, (const int32_t*)idx,
                             (const uint8_t*)valid, (int32_t*)counts, nk, W, tiles, chunks);
  return (int)cudaGetLastError();
}

int search_args_check(int64_t nq, int64_t nh, int64_t W) {
  return nq <= 0 || W <= 0 || nh <= 0 || nh > kMaxNh ? (int)cudaErrorInvalidValue : 0;
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
  if (int err = search_args_check(nq, nh, W)) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(nq * W * 32) * sizeof(int32_t), st))
    return (int)err;
  return launch_chunks(db, idx, valid, out, nq, nk, nh, W, st);
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
  if (int err = launch_chunks(db, idx, valid, scratch, nq, nk, nh, W, st)) return err;
  search_hits_kernel<<<(unsigned)(tiles * nq), kThreads, 0, st>>>(
      (const int32_t*)tcount, (const int32_t*)scratch, (int32_t*)out, W, tiles);
  return (int)cudaGetLastError();
}
