// The card's integer roof, measured: chains of int32 IMAD and LOP3 on every
// SM. Measurement only (kernels/time_kernel.py roof); not built into the
// kernel library.
//
// Each operation is one instruction, written in PTX (mad.lo.u32, lop3.b32)
// so that the compiler cannot merge two of them into one. Each LOP3 takes a
// second chain's value as an operand, so no two LOP3s of a chain have three
// inputs between them (three inputs would fold into one LOP3). A thread runs
// kChains chains; the grid puts 8 blocks of 256 threads on each SM (16 warps
// a scheduler), and the step loop is unrolled kUnroll times, so its own
// counter and branch are one instruction in about a hundred.
//
// mode 0: one IMAD and one LOP3 a chain and step (two pipes: IMAD goes
// to the FMA pipe, LOP3 to the integer ALU); mode 1: two IMADs; mode 2: two
// LOP3s. Every mode does 2 operations a chain and step: the caller counts
// grid x 256 x kChains x 2 x steps. Thread 0 of block 0 writes its SM's
// cycles and the nanoseconds of its run to clocks[0..1], which gives the
// clock the rate was measured at. The chains' sum goes to clocks[2] only
// when it equals an impossible value, so nothing is optimised away.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ uint32_t mad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(LUT));
  return d;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 8) int_roof_kernel(uint64_t* clocks, int steps,
                                                              uint32_t seed) {
  const bool timer = threadIdx.x == 0 && blockIdx.x == 0;
  long long c0 = 0;
  uint64_t t0 = 0;
  if (timer) {
    c0 = clock64();
    t0 = global_ns();
  }
  uint32_t x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = seed + threadIdx.x * kChains + c;
  const uint32_t mul = seed | 1u, add = seed * 7u + 3u, key = seed ^ 0x5bd1e995u;
  for (int s = 0; s < steps; s += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const uint32_t y = x[(c + 1) % kChains], z = x[(c + 3) % kChains];
        if (MODE == 0) {
          x[c] = mad(x[c], mul, add);
          x[c] = lop3<0x96>(x[c], y, key);          // x ^ y ^ key
        } else if (MODE == 1) {
          x[c] = mad(x[c], mul, add);
          x[c] = mad(x[c], y, key);
        } else {
          x[c] = lop3<0x96>(x[c], y, key);          // x ^ y ^ key
          x[c] = lop3<0xE8>(x[c], z, mul);          // majority(x, z, mul)
        }
      }
    }
  }
  uint32_t sum = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) sum += x[c];
  if (sum == 0x9e3779b9u && seed == 0) clocks[2] = sum;
  if (timer) {
    clocks[0] = (uint64_t)(clock64() - c0);
    clocks[1] = global_ns() - t0;
  }
}

}  // namespace

// grid: blocks of 256 threads; steps: a multiple of 4; operations = grid *
// 256 * 8 * 2 * steps. clocks: uint64 [3].
extern "C" int kw_int_roof(void* clocks, int64_t grid, int64_t steps, int64_t mode,
                           void* stream) {
  if (grid < 1 || steps < kUnroll || steps % kUnroll || steps > INT32_MAX || mode < 0 ||
      mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t seed = 0x1234567u;
  uint64_t* out = (uint64_t*)clocks;
  if (mode == 0)
    int_roof_kernel<0><<<(unsigned)grid, kThreads, 0, s>>>(out, (int)steps, seed);
  else if (mode == 1)
    int_roof_kernel<1><<<(unsigned)grid, kThreads, 0, s>>>(out, (int)steps, seed);
  else
    int_roof_kernel<2><<<(unsigned)grid, kThreads, 0, s>>>(out, (int)steps, seed);
  return (int)cudaGetLastError();
}
