// sriracha_words_hash: the block-a-row kernel (sriracha_block.cuh) from
// canonical words with the bucketed hash probe, in a translation unit of
// its own so that nvcc compiles its instances beside the others: the rows
// of at most 2^14 windows of sriracha_counts_hash (sriracha.cu), which
// calls it.
//
// Replaces: kwage_tpu/sriracha/device.py _read_batch_kernel_hash (:179)
// over _kmerize_batch64's words (:159), for rows of at most 2^14 windows.
//
// Bound: as sriracha_block.cuh states. Design: that header's kernel with
// its words source.

#include "sriracha_block.cuh"

// (words, valid, lengths, keys, masks, row0, bmask, out, B, nwin, k, ns,
//  out_stride, stream): words int64 and validity uint8 [B, nwin]; a row of
// more than 2^14 windows in its read gets zeros.
extern "C" int kw_sriracha_words_hash(const void* words, const void* valid, const void* lengths,
                                      const void* keys, const void* masks, const void* row0,
                                      const void* bmask, void* out, int64_t B, int64_t nwin,
                                      int64_t k, int64_t ns, int64_t out_stride, void* stream) {
  return launch_block_words(words, valid, lengths,
                            HashProbe{(const unsigned long long*)keys, (const uint32_t*)masks,
                                      (const long long*)row0, (const long long*)bmask},
                            out, B, nwin, k, ns, out_stride, stream);
}
