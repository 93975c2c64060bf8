"""Bloom filter parameters and the COBS-style adaptive sizing solver.

Bit-faithful to the reference solver (bloom.cpp:10-121): a grid search over
log2 filter length L and hash count h that returns the *smallest* L
admitting any h with per-k-mer false-positive probability p <= target,
choosing the h with minimum p at that L. The reference stores the running
best probability in a C ``float``; we reproduce that narrowing so tie-break
behavior matches exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .hash import MURMUR_HASH_32

MIN_NUM_HASH = 1  # bloom.h:20
MAX_NUM_HASH = 5  # bloom.h:21

# Defaults mirrored from options.h:131-157
DEFAULT_KMER_LENGTH = 31
DEFAULT_FALSE_POSITIVE_PROBABILITY = 0.25
DEFAULT_SRA_MIN_KMER_COUNT = 5
MAX_SRA_MIN_KMER_COUNT = 15
DEFAULT_MIN_LOG_2_FILTER_LEN = 18
DEFAULT_MAX_LOG_2_FILTER_LEN = 32
DEFAULT_SEARCH_THRESHOLD = 1.0
MAX_NUM_FILTER_CHUNK = 2048
MAX_DATABASE_FILE_SIZE_IN_GB = 64


@dataclass(frozen=True, order=True)
class BloomParam:
    """Bloom filter shape: (kmer_len, log_2_filter_len, num_hash, hash_func).

    Ordering matches bloom.h:584-596 (kmer_len, then log_2_filter_len, then
    num_hash). The dataclass additionally tiebreaks on hash_func, which the
    reference's operator< ignores -- indistinguishable in practice since
    only MURMUR_HASH_32 exists, and grouping equality covers all fields
    either way.
    """

    kmer_len: int = 0
    log_2_filter_len: int = 0
    num_hash: int = 0
    hash_func: int = 0

    @property
    def filter_len(self) -> int:
        return 1 << self.log_2_filter_len

    @property
    def empty(self) -> bool:
        return self.kmer_len == 0 and self.log_2_filter_len == 0 and self.num_hash == 0


def optimal_bloom_param(
    kmer_len: int,
    num_kmer: int,
    p: float,
    hash_func: int = MURMUR_HASH_32,
    min_log_2_filter_len: int = DEFAULT_MIN_LOG_2_FILTER_LEN,
    max_log_2_filter_len: int = DEFAULT_MAX_LOG_2_FILTER_LEN,
) -> BloomParam:
    """Smallest Bloom filter meeting the false-positive bound (bloom.cpp:10-68).

    Raises ValueError when no k-mers were found or no (L, h) satisfies the
    bound, mirroring the reference's exceptions.
    """
    if num_kmer == 0:
        raise ValueError("optimal_bloom_param: No kmers found")

    # The reference receives the target as a C float; honor that rounding.
    target = float(np.float32(p))

    for L in range(min_log_2_filter_len, max_log_2_filter_len + 1):
        best_p = np.float32(10.0)
        best_h = 0
        valid = False
        flen = float(1 << L)
        for num_hash in range(MIN_NUM_HASH, MAX_NUM_HASH + 1):
            prob = (1.0 - (1.0 - 1.0 / flen) ** (num_kmer * num_hash)) ** num_hash
            if prob <= target and prob < float(best_p):
                best_p = np.float32(prob)
                best_h = num_hash
                valid = True
        if valid:
            return BloomParam(
                kmer_len=kmer_len,
                log_2_filter_len=L,
                num_hash=best_h,
                hash_func=hash_func,
            )

    raise ValueError("optimal_bloom_param: Unable to satisfy Bloom filter probability bound")


@lru_cache(maxsize=64)
def approximate_max_kmers(
    p: float,
    hash_func: int = MURMUR_HASH_32,
    min_log_2_filter_len: int = DEFAULT_MIN_LOG_2_FILTER_LEN,
    max_log_2_filter_len: int = DEFAULT_MAX_LOG_2_FILTER_LEN,
) -> int:
    """Smallest 2**j k-mer count with no feasible params (bloom.cpp:72-121).

    Pure in its arguments and called once per accession by every build
    path -- cached (measured 0.27 ms/call, ~3% of a small host build)."""
    target = float(np.float32(p))

    for log2_num_kmer in range(1, 64):
        num_kmer = 1 << log2_num_kmer
        valid = False
        for L in range(min_log_2_filter_len, max_log_2_filter_len + 1):
            if valid:
                break
            flen = float(1 << L)
            for num_hash in range(MIN_NUM_HASH, MAX_NUM_HASH + 1):
                prob = (1.0 - (1.0 - 1.0 / flen) ** (num_kmer * num_hash)) ** num_hash
                if prob <= target:
                    valid = True
                    break
        if not valid:
            return num_kmer

    return 0xFFFFFFFFFFFFFFFF


def filters_per_file_quota(log_2_filter_len: int) -> int:
    """Per-shape database file quota (maestro_main.cpp:87-106).

    min(MAX_NUM_FILTER_CHUNK, bits available in a MAX_DATABASE_FILE_SIZE_IN_GB
    file divided by the filter length).
    """
    max_bits = MAX_DATABASE_FILE_SIZE_IN_GB * (1 << 30) * 8
    return int(min(MAX_NUM_FILTER_CHUNK, max_bits // (1 << log_2_filter_len)))
