"""Murmur3-32 of canonical k-mers, frozen (NumPy and plain PyTorch).

KWAGE hashes the decoded ASCII string of the canonical k-mer ("ACGT"[code],
first base first), with the hash index 0..num_hash-1 as the murmur seed
(hash.cpp:114-332); a slice row is ``hash & (2^L - 1)`` (kwage.cpp:411-413).

This file imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

C1, C2, C3 = 0xCC9E2D51, 0x1B873593, 0xE6546B64
F1, F2 = 0x85EBCA6B, 0xC2B2AE35
M32 = 0xFFFFFFFF
_ASCII = (65, 67, 71, 84)


def murmur_np(words: np.ndarray, k: int, nh: int) -> np.ndarray:
    """uint32 [n, nh]: murmur3-32 of each k-mer word, seeds 0..nh-1."""
    w = np.asarray(words, dtype=np.uint64)
    n = w.shape[0]
    asc = np.array(_ASCII, dtype=np.uint32)

    def base(i):
        return asc[((w >> np.uint64(2 * (k - 1 - i))) & np.uint64(3)).astype(np.intp)]

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    with np.errstate(over="ignore"):
        h = np.tile(np.arange(nh, dtype=np.uint32), (n, 1))
        for blk in range(k // 4):
            k1 = np.zeros(n, dtype=np.uint32)
            for b in range(4):
                k1 |= base(4 * blk + b) << np.uint32(8 * b)
            k1 = rotl(k1 * np.uint32(C1), 15) * np.uint32(C2)
            h = rotl(h ^ k1[:, None], 13) * np.uint32(5) + np.uint32(C3)
        if k & 3:
            k1 = np.zeros(n, dtype=np.uint32)
            for t in range(k & 3):
                k1 ^= base(4 * (k // 4) + t) << np.uint32(8 * t)
            h ^= (rotl(k1 * np.uint32(C1), 15) * np.uint32(C2))[:, None]
        h ^= np.uint32(k)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(F1)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(F2)
        h ^= h >> np.uint32(16)
    return h


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def murmur_torch(words: torch.Tensor, k: int, nh: int) -> torch.Tensor:
    """int64 [..., nh] with values in [0, 2^32): murmur3-32 of each k-mer
    word (int64, k <= 31), seeds 0..nh-1, on the words' device."""
    asc = torch.tensor(_ASCII, dtype=torch.int64, device=words.device)

    def base(i):
        return asc[(words >> (2 * (k - 1 - i))) & 3]

    blocks = []
    for blk in range(k // 4):
        k1 = base(4 * blk)
        for b in range(1, 4):
            k1 = k1 | (base(4 * blk + b) << (8 * b))
        blocks.append(_mul(_rotl(_mul(k1, C1), 15), C2))
    tail = None
    if k & 3:
        k1 = torch.zeros_like(words)
        for t in range(k & 3):
            k1 = k1 ^ (base(4 * (k // 4) + t) << (8 * t))
        tail = _mul(_rotl(_mul(k1, C1), 15), C2)
    out = []
    for seed in range(nh):
        h = torch.full_like(words, seed)
        for k1 in blocks:
            h = (_mul(_rotl(h ^ k1, 13), 5) + C3) & M32
        if tail is not None:
            h = h ^ tail
        h = h ^ k
        h = _mul(h ^ (h >> 16), F1)
        h = _mul(h ^ (h >> 13), F2)
        out.append(h ^ (h >> 16))
    return torch.stack(out, dim=-1)
