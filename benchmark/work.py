"""The work a window asked of the device, worked out from its inputs, and the
chip's published peaks.

A search reads, for each valid (distinct canonical) k-mer of a query, its
``num_hash`` slice rows across every searched word (W words of 4 bytes in
all files side by side), the k-mer's row indices once, and writes its
result once: per-filter counts (threshold < 1, 4 bytes a filter) or a
complete-match mask (threshold 1.0, 4 bytes a word). The gather term is
the arithmetic of ``gathered_bytes`` in the program's search bench.
"""

from __future__ import annotations

import torch

from .reference.kmers import canonical_torch, encode

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3.
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}


def search_bytes(num_kmers: int, num_hash: int, words: int, threshold: float) -> int:
    """Bytes one query's search must move at the least."""
    out = 4 * words * (32 if threshold < 1.0 else 1)
    return num_kmers * num_hash * (4 * words + 4) + out


def distinct_kmers(queries: list[str], k: int, device: torch.device,
                   rows_at_once: int = 1 << 25) -> list[int]:
    """Each query's number of distinct canonical k-mers (every base ACGT),
    counted on ``device`` in batches of queries of one length."""
    out = [0] * len(queries)
    by_len: dict[int, list[int]] = {}
    for i, q in enumerate(queries):
        by_len.setdefault(len(q), []).append(i)
    for n, idx in by_len.items():
        if n < k:
            continue
        step = max(1, rows_at_once // n)
        for s in range(0, len(idx), step):
            part = idx[s : s + step]
            codes = torch.stack([torch.from_numpy(encode(queries[i])) for i in part]).to(device)
            words = canonical_torch(codes, k).sort(dim=1).values
            counts = 1 + (words[:, 1:] != words[:, :-1]).sum(dim=1)
            for i, c in zip(part, counts.tolist()):
                out[i] = int(c)
    return out
