// sriracha_block_hash: the block-a-read kernel (sriracha_block.cuh) with
// the bucketed hash probe, in a translation unit of its own so that nvcc
// compiles its instances beside the others.
//
// Replaces: kwage_tpu/sriracha/device.py _kmerize_batch64 (:159) with
// _read_batch_kernel_hash (:179), for reads of 1-16 kbp.
//
// Bound: as sriracha_block.cuh states. Design: that header's kernel.

#include "sriracha_block.cuh"

// (reads, lengths, keys, masks, row0, bmask, out, B, L, k, ns, out_stride,
//  stream)
extern "C" int kw_sriracha_block_hash(const void* reads, const void* lengths,
                                      const void* keys, const void* masks,
                                      const void* row0, const void* bmask, void* out,
                                      int64_t B, int64_t L, int64_t k, int64_t ns,
                                      int64_t out_stride, void* stream) {
  return launch_block_ascii(reads, lengths,
                            HashProbe{(const unsigned long long*)keys, (const uint32_t*)masks,
                                      (const long long*)row0, (const long long*)bmask},
                            out, B, L, k, ns, out_stride, stream);
}
