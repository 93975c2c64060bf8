// sriracha_block_lut: the block-a-read kernel (sriracha_block.cuh) with
// the dense LUT probe, in a translation unit of its own so that nvcc
// compiles its instances beside the others.
//
// Replaces: kwage_tpu/sriracha/device.py _kmerize_batch (:50) with
// _read_batch_kernel_tables (:239), for reads of 1-16 kbp.
//
// Bound: as sriracha_block.cuh states. Design: that header's kernel.

#include "sriracha_block.cuh"

// (reads, lengths, table, out, B, L, k, size, ns, out_stride, stream):
// ASCII reads uint8 [B, L], L - k + 1 <= 2^14.
extern "C" int kw_sriracha_block_lut(const void* reads, const void* lengths,
                                     const void* table, void* out, int64_t B, int64_t L,
                                     int64_t k, int64_t size, int64_t ns,
                                     int64_t out_stride, void* stream) {
  if (size < 1) return (int)cudaErrorInvalidValue;
  return launch_block_ascii(reads, lengths, LutProbe{(const uint32_t*)table, size}, out, B,
                            L, k, ns, out_stride, stream);
}
