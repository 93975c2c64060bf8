"""The plain search: which runs' Bloom filters hold a query's k-mers.

For each query: its distinct canonical k-mers (``kmers.distinct_np``), each
k-mer's ``num_hash`` slice rows (``murmur.murmur_np`` & (2^L - 1)); a run
counts a k-mer when all of the k-mer's rows have the run's bit set. A run is
a hit when its count is at least ``threshold_count`` (kwage.cpp:388). Hits
are listed in file order, then filter order, then by a stable sort on the
count, descending (the reference binary's output order). A query with no
k-mer, or with no hit, is absent from the answer, as in the rendered output.

The slice matrix comes from the benchmark's own data; this file imports
nothing of the program under test and uses plain PyTorch on the device it
is given (a CPU tensor works the same).
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import distinct_np
from .murmur import murmur_np

# Bits counted at once: [chunk, W, 32] int32 of at most 2^26 entries.
COUNT_ENTRIES = 1 << 26


def threshold_count(threshold: float, num_kmers: int) -> int:
    """trunc(float32(threshold) * float32(num_kmers)) (kwage.cpp:388)."""
    return int(np.float32(threshold) * np.float32(num_kmers))


class SearchReference:
    """``db``: int32 [2^L, W] slice words of every file side by side (bit b
    of word w is filter 32 w + b of the corpus, in file order); ``names``:
    the run accession of each filter."""

    def __init__(self, db: torch.Tensor, names: list[str], k: int, num_hash: int,
                 log2_len: int):
        if db.shape[0] != 1 << log2_len or len(names) > 32 * db.shape[1]:
            raise ValueError("slice matrix and names do not agree")
        self.db, self.names = db, names
        self.k, self.nh, self.mask = k, num_hash, (1 << log2_len) - 1
        self.shifts = torch.arange(32, dtype=torch.int32, device=db.device)

    def counts(self, kmers: np.ndarray) -> np.ndarray:
        """int64 [num filters]: how many of ``kmers`` each filter holds."""
        rows = torch.from_numpy((murmur_np(kmers, self.k, self.nh) & self.mask)
                                .astype(np.int64)).to(self.db.device)
        W = self.db.shape[1]
        out = torch.zeros((W, 32), dtype=torch.int64, device=self.db.device)
        step = max(1, COUNT_ENTRIES // (32 * W))
        for c0 in range(0, rows.shape[0], step):
            r = rows[c0 : c0 + step]
            m = self.db.index_select(0, r[:, 0])
            for h in range(1, self.nh):
                m = m & self.db.index_select(0, r[:, h])
            out += ((m.unsqueeze(-1) >> self.shifts) & 1).sum(0)
        return out.reshape(-1)[: len(self.names)].cpu().numpy()

    def hits(self, query: str, threshold: float, kmer_step: int = 1) -> list[tuple]:
        """[(run accession, k-mers found, k-mers of the query)] in output
        order. ``kmer_step`` > 1 keeps every kmer_step-th distinct k-mer
        only: an approximate search, the control that must fail the check."""
        kmers = distinct_np(query, self.k)[::kmer_step]
        n = len(kmers)
        if n == 0:
            return []
        c = self.counts(kmers)
        found = np.nonzero(c >= threshold_count(threshold, n))[0]
        hits = [(self.names[f], int(c[f]), n) for f in found]
        hits.sort(key=lambda h: -h[1])
        return hits

    def answer(self, queries: list[str], threshold: float, kmer_step: int = 1) -> dict:
        """{query index: hits} for the queries with at least one hit."""
        out = {}
        for i, q in enumerate(queries):
            h = self.hits(q, threshold, kmer_step)
            if h:
                out[i] = h
        return out
