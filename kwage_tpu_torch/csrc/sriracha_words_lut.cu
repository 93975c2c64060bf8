// sriracha_words_lut: the block-a-row kernel (sriracha_block.cuh) from
// canonical words with the dense LUT probe, in a translation unit of its
// own so that nvcc compiles its instances beside the others: the rows of at
// most 2^14 windows of sriracha_counts_lut (sriracha.cu), which calls it.
//
// Replaces: kwage_tpu/sriracha/device.py _read_batch_kernel_tables (:239)
// over _kmerize_batch's words (:50), for rows of at most 2^14 windows.
//
// Bound: as sriracha_block.cuh states. Design: that header's kernel with
// its words source.

#include "sriracha_block.cuh"

// (words, valid, lengths, table, out, B, nwin, k, size, ns, out_stride,
//  stream): words int64 and validity uint8 [B, nwin]; a row of more than
// 2^14 windows in its read gets zeros.
extern "C" int kw_sriracha_words_lut(const void* words, const void* valid, const void* lengths,
                                     const void* table, void* out, int64_t B, int64_t nwin,
                                     int64_t k, int64_t size, int64_t ns, int64_t out_stride,
                                     void* stream) {
  if (size < 1) return (int)cudaErrorInvalidValue;
  return launch_block_words(words, valid, lengths, LutProbe{(const uint32_t*)table, size}, out,
                            B, nwin, k, ns, out_stride, stream);
}
