// SriRachA's probes and sort steps, shared by sriracha.cu (sriracha_counts,
// sriracha_reads, the long-row tiles) and sriracha_block.cuh (the block-a-
// read kernel, compiled in translation units of its own so that nvcc builds
// it beside the rest): the bucket hash, the padded tile index, a tile's
// strides in registers, the LUT and hash probes.
//
// Replaces: kwage_tpu/sriracha/device.py _mix32 (:91) and the probes of
// _read_batch_kernel_tables (:239, one LUT gather) and
// _read_batch_kernel_hash (:179, one row of 8 (key, mask) slots).
//
// Bound: a probe is a random gather from its table (a LUT entry; a hash
// row's 64 bytes of keys and 32 of masks), latency-bound where the table
// is larger than the 50 MB L2.
//
// Design: each probe comes in steps that issue loads before any result is
// used, so that a caller keeps several in flight: load / mask (a hash
// probe's whole row, sriracha_reads) and load_keys / mask_of (a hash
// probe's keys, then only a matching slot's mask: sriracha_block).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBucketCap = 8;
constexpr int kTileLog = 14;
constexpr int kTile = 1 << kTileLog;  // sort slots per long-row tile (== kMaxSharedWords)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t hi, uint32_t lo) {
  uint32_t x = lo ^ (lo >> 16);
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  uint32_t y = hi ^ (hi >> 16);
  y *= 0x9E3779B1u;
  y ^= y >> 13;
  y *= 0x85EBCA6Bu;
  y ^= y >> 16;
  return x ^ y;
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// The strides 2^(b+NL-1) .. 2^b of merge level ``size`` over a padded tile
// of N slots: a thread owns the 2^NL slots that differ in bits [b, b + NL),
// takes them into registers, runs the NL stages there and writes them back.
// ``size`` is above every stride, so one direction holds for all of a
// thread's slots.
template <int NL, typename Key = uint64_t, int N = kTile>
__device__ __forceinline__ void tile_strides(Key* s, int b, int64_t base, int64_t size) {
  constexpr int E = 1 << NL;
  for (int t = threadIdx.x; t < (N >> NL); t += blockDim.x) {
    const int first = ((t >> b) << (b + NL)) | (t & ((1 << b) - 1));
    const bool asc = ((base + first) & size) == 0;
    Key v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = s[padded(first | (e << b))];
#pragma unroll
    for (int l = NL - 1; l >= 0; --l) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((e & (1 << l)) == 0) {
          const Key a = v[e], c = v[e | (1 << l)];
          if ((a > c) == asc) {
            v[e] = c;
            v[e | (1 << l)] = a;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s[padded(first | (e << b))] = v[e];
  }
}

struct LutProbe {
  const uint32_t* table;  // [G, size]
  int64_t size;           // 4^k
  __device__ uint32_t operator()(int g, uint64_t w) const {
    return w < (uint64_t)size ? __ldg(table + g * size + (int64_t)w) : 0u;
  }
  // The fused kernel's probe in two steps: the loads, then the mask; a
  // lane's probes of a group all go out at once (a word each).
  static constexpr int kInFlight = 16;
  using Row = uint32_t;
  __device__ Row load(int g, uint64_t w) const { return (*this)(g, w); }
  __device__ uint32_t mask(const Row& row, uint64_t) const { return row; }
  // The block kernel's probe: the same.
  using Keys = uint32_t;
  __device__ Keys load_keys(int g, uint64_t w) const { return (*this)(g, w); }
  __device__ uint32_t mask_of(const Keys& row, uint64_t) const { return row; }
};

struct HashProbe {
  const unsigned long long* keys;  // [rows, kBucketCap]; empty slots all-ones
  const uint32_t* masks;  // [rows, kBucketCap]; empty slots 0
  const long long* row0;   // [G] first row of group g
  const long long* bmask;  // [G] 2^m_g - 1
  __device__ uint32_t operator()(int g, uint64_t w) const {
    const uint32_t b =
        mix32((uint32_t)(w >> 32), (uint32_t)w) & (uint32_t)bmask[g];
    const int64_t slot = (row0[g] + b) * kBucketCap;
    uint32_t m = 0;
#pragma unroll
    for (int c = 0; c < kBucketCap; ++c)
      if (keys[slot + c] == w) m |= __ldg(masks + slot + c);
    return m;
  }
  // The fused kernel's probe in two steps: the whole bucket row in six
  // 16-byte loads (its 64 bytes of keys, its 32 of masks), none waiting on
  // a compare; then the mask. Four a lane at once (96 registers).
  static constexpr int kInFlight = 4;
  struct Row {
    ulonglong2 k[kBucketCap / 2];
    uint4 m[2];
  };
  __device__ Row load(int g, uint64_t w) const {
    const uint32_t b =
        mix32((uint32_t)(w >> 32), (uint32_t)w) & (uint32_t)__ldg(bmask + g);
    const int64_t slot = (__ldg(row0 + g) + b) * kBucketCap;
    const ulonglong2* kp = reinterpret_cast<const ulonglong2*>(keys + slot);
    const uint4* mp = reinterpret_cast<const uint4*>(masks + slot);
    Row row;
#pragma unroll
    for (int c = 0; c < kBucketCap / 2; ++c) row.k[c] = __ldg(kp + c);
    row.m[0] = __ldg(mp);
    row.m[1] = __ldg(mp + 1);
    return row;
  }
  __device__ uint32_t mask(const Row& row, uint64_t w) const {
    const uint32_t ms[kBucketCap] = {row.m[0].x, row.m[0].y, row.m[0].z, row.m[0].w,
                                     row.m[1].x, row.m[1].y, row.m[1].z, row.m[1].w};
    uint32_t m = 0;
#pragma unroll
    for (int c = 0; c < kBucketCap / 2; ++c)
      m |= (row.k[c].x == w ? ms[2 * c] : 0u) | (row.k[c].y == w ? ms[2 * c + 1] : 0u);
    return m;
  }
  // The block kernel's probe in two steps that move less: the row's 64
  // bytes of keys in four 16-byte loads, then the 4-byte mask of the one
  // slot whose key is w (a group's words are distinct), loaded only where
  // a key matched: a miss reads two sectors, not three.
  struct Keys {
    ulonglong2 k[kBucketCap / 2];
    int64_t slot;
  };
  __device__ Keys load_keys(int g, uint64_t w) const {
    const uint32_t b =
        mix32((uint32_t)(w >> 32), (uint32_t)w) & (uint32_t)__ldg(bmask + g);
    Keys row;
    row.slot = (__ldg(row0 + g) + b) * kBucketCap;
    const ulonglong2* kp = reinterpret_cast<const ulonglong2*>(keys + row.slot);
#pragma unroll
    for (int c = 0; c < kBucketCap / 2; ++c) row.k[c] = __ldg(kp + c);
    return row;
  }
  __device__ uint32_t mask_of(const Keys& row, uint64_t w) const {
    int hit = -1;
#pragma unroll
    for (int c = 0; c < kBucketCap / 2; ++c) {
      hit = row.k[c].x == w ? 2 * c : hit;
      hit = row.k[c].y == w ? 2 * c + 1 : hit;
    }
    return hit < 0 ? 0u : __ldg(masks + row.slot + hit);
  }
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
