"""Pure-Python counting builder (used when no C++ toolchain is present).

Bit-identical to the native implementation; only suitable for small inputs.
"""

from __future__ import annotations

import numpy as np

from ..core.hash import murmur32_words
from ..core.words import canonical_kmers

MAX_PLANES = 5


class PyCountingBuilder:
    def __init__(self, k: int, min_count: int, log2_count_len: int,
                 max_log2_filter_len: int):
        self.k = k
        self.min_count = min_count
        self.count_mask = (1 << log2_count_len) - 1
        self.seq_mask = (1 << max_log2_filter_len) - 1
        self.plane_bits = 1 << max_log2_filter_len
        self.cells_a = np.zeros(1 << log2_count_len, dtype=np.uint8)
        self.cells_b = np.zeros(1 << log2_count_len, dtype=np.uint8)
        self.planes = np.zeros((MAX_PLANES, self.plane_bits // 8), dtype=np.uint8)
        self.num_valid_kmer = 0
        self.num_bp = 0

    def add_sequence(self, seq: str | bytes) -> None:
        self.num_bp += len(seq)
        words = canonical_kmers(seq, self.k)
        if words.size == 0:
            return
        hashes = murmur32_words(words, self.k, MAX_PLANES)
        a, b = self.cells_a, self.cells_b
        cm, sm = self.count_mask, self.seq_mask
        for row in hashes:
            i0, i1 = int(row[0]) & cm, int(row[1]) & cm
            i2, i3 = int(row[2]) & cm, int(row[3]) & cm
            v0, v1, v2, v3 = int(a[i0]), int(a[i1]), int(b[i2]), int(b[i3])
            mn = min(v0, v1, v2, v3)
            if mn >= self.min_count:
                continue
            if mn == self.min_count - 1:
                self.num_valid_kmer += 1
                for h in range(MAX_PLANES):
                    bit = int(row[h]) & sm
                    self.planes[h, bit >> 3] |= 1 << (bit & 7)
            # True in-place increments with 4-bit wrap, matching the
            # reference's bitfield ++ even when seed indices alias.
            if v0 == mn:
                a[i0] = (int(a[i0]) + 1) & 0xF
            if v1 == mn:
                a[i1] = (int(a[i1]) + 1) & 0xF
            if v2 == mn:
                b[i2] = (int(b[i2]) + 1) & 0xF
            if v3 == mn:
                b[i3] = (int(b[i3]) + 1) & 0xF

    def fold(self, log2_filter_len: int, num_hash: int) -> np.ndarray:
        dst_bytes = (1 << log2_filter_len) // 8
        out = np.zeros(dst_bytes, dtype=np.uint8)
        for h in range(min(num_hash, MAX_PLANES)):
            out |= np.bitwise_or.reduce(
                self.planes[h].reshape(-1, dst_bytes), axis=0)
        return out
