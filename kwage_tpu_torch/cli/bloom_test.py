"""bloom_test: counting-Bloom thresholding vs exact ground truth.

The reference rig (bloom_test.cpp:37-443, GROUND_TRUTH path) streams one
accession through the approximate two-plane counting filter AND an exact
``unordered_map<Word, count>`` tally, then reports per-bit differences.
This is the accuracy oracle for the de-noising stage. Differences are
almost always early promotions (counting-filter false positives); in
rare aliasing cases the min-cell count can jump PAST the
``== min_count-1`` crossing and suppress a truly abundant k-mer, so
suppressions are reported separately (the reference's measured ~0.1%
bit-difference notes, make_bloom.cpp:35-45, include both directions).

Inputs here are local FASTA/FASTQ(.gz) files (SRA streaming is a
pluggable source in this engine, see kwage_tpu.parallel.maestro). The
default plane length is 2^28 (the reference pins 2^32, bloom_test.cpp:
118; pass --len.max 32 for the full-size run if RAM allows).
"""

from __future__ import annotations

import getopt
import sys
import time
from collections import Counter

import numpy as np

from ..core.words import canonical_kmers
from ..io.sequence import iter_sequences
from ..native import CountingBuilder, murmur32_native
from ..pipeline.make_bloom import BuildOptions, counting_filter_log2_len
from ._render import cli_errors

MAX_NUM_HASH = 5

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint64)


def _popcount(packed: np.ndarray) -> int:
    return int(_POPCOUNT8[packed].sum())


def _usage(out=sys.stderr) -> None:
    print("Usage: bloom_test [options] <FASTA/FASTQ sequence file>", file=out)
    print("\t[-k <kmer length>] (default is 31)", file=out)
    print("\t[--min-kmer-count <minimum allowed k-mer count>] (default is 5)", file=out)
    print("\t[--len.max <max log2 Bloom filter len>] (default is 28)", file=out)
    print("\t[--len.count <log2 counting filter len>] (default sized from bp)", file=out)
    print("\t[--max-read <only stream the first N reads>]", file=out)


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(
            argv, "k:h?", ["min-kmer-count=", "len.max=", "len.count=", "max-read="]
        )
    except getopt.GetoptError as e:
        print(f"Unknown option: {e}", file=sys.stderr)
        return 1

    k = 31
    min_kmer_count = 5
    max_log2_filter_len = 28
    log2_count_len = None
    max_read = None
    for flag, value in opts:
        if flag == "-k":
            k = int(value)
        elif flag == "--min-kmer-count":
            min_kmer_count = int(value)
        elif flag == "--len.max":
            max_log2_filter_len = int(value)
        elif flag == "--len.count":
            log2_count_len = int(value)
        elif flag == "--max-read":
            max_read = int(value)
        else:
            _usage()
            return 0
    if len(args) != 1:
        _usage()
        return 0
    path = args[0]

    t0 = time.time()
    reads: list[str] = []
    num_bp = 0
    for _, seq in iter_sequences(path):
        reads.append(seq)
        num_bp += len(seq)
        if max_read is not None and len(reads) >= max_read:
            break
    print(f"Found {len(reads)} reads ({num_bp} bp)", file=sys.stderr)

    if log2_count_len is None:
        log2_count_len = counting_filter_log2_len(num_bp, BuildOptions())
    print(f"Counting filter log2 length = {log2_count_len}", file=sys.stderr)

    seq_mask = (1 << max_log2_filter_len) - 1
    plane_len = 1 << max_log2_filter_len

    # Approximate path (the production kernel) + exact multiset tally.
    counts: Counter = Counter()
    with CountingBuilder(k, min_kmer_count, log2_count_len, max_log2_filter_len) as b:
        for seq in reads:
            b.add_sequence(seq)
            counts.update(canonical_kmers(seq, k).tolist())
        approx_valid = b.num_valid_kmer
        # Folding to maxL is the identity stride, so this is the OR of the
        # five valid-bit planes at full length (packed, LSB-first).
        approx_filter = b.fold(max_log2_filter_len, MAX_NUM_HASH)

    # Ground truth: bits of every exactly-thresholded k-mer.
    exact_words = np.array(
        [w for w, c in counts.items() if c >= min_kmer_count], dtype=np.uint64
    )
    exact_valid = exact_words.shape[0]
    gt_filter = np.zeros(plane_len // 8, dtype=np.uint8)
    if exact_valid:
        hashes = murmur32_native(exact_words, k, MAX_NUM_HASH)
        idx = (hashes & np.uint32(seq_mask)).reshape(-1).astype(np.uint64)
        np.bitwise_or.at(
            gt_filter, (idx >> 3).astype(np.int64), np.uint8(1) << (idx & 7).astype(np.uint8)
        )

    dt = time.time() - t0
    extra = approx_valid - exact_valid
    print(f"Exact thresholded k-mers    = {exact_valid}")
    print(f"Counting-filter thresholded = {approx_valid}")
    print(
        "False-positive promotions   = "
        f"{extra} ({100.0 * extra / max(1, exact_valid):.4f}%)"
    )
    approx_set = _popcount(approx_filter)
    gt_set = _popcount(gt_filter)
    diff = _popcount(np.bitwise_xor(approx_filter, gt_filter))
    print(f"Bits set (approx / exact)   = {approx_set} / {gt_set}")
    print(
        "Bit differences             = "
        f"{diff} ({100.0 * diff / max(1, plane_len):.6f}% of {plane_len} bits)"
    )
    missing = _popcount(np.bitwise_and(gt_filter, np.bitwise_not(approx_filter)))
    print(f"Suppressed ground-truth bits = {missing}")
    print(f"Completed in {dt:.2f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
