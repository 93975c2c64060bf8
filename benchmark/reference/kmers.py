"""Canonical k-mers, frozen (NumPy and plain PyTorch).

KWAGE's k-mer rules (word.h:19, 73-168): A=0, C=1, G=2, T=3; a k-mer word
packs its first base into the highest 2 bits; the canonical word is
min(sense, reverse complement) as unsigned integers; a window counts only
when all k of its bases are ACGT. A query's k-mers are its distinct
canonical words (kwage.cpp:352-366).

This file imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _CODE[_b] = _i


def encode(seq: str | bytes) -> np.ndarray:
    """Base codes uint8 (0-3; 255 for anything but ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return _CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """ASCII string of base codes 0-3."""
    return ASCII[codes].tobytes().decode("ascii")


def canonical_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical words uint64 of every valid window of ``codes``, in order."""
    n = codes.shape[0]
    if n < k:
        return np.empty(0, dtype=np.uint64)
    nwin = n - k + 1
    bad = codes == 255
    cs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(bad, out=cs[1:])
    valid = (cs[k:] - cs[:-k]) == 0
    c = np.where(bad, 0, codes).astype(np.uint64)
    comp = np.uint64(3) - c
    sense = np.zeros(nwin, dtype=np.uint64)
    anti = np.zeros(nwin, dtype=np.uint64)
    for j in range(k):
        sense = (sense << np.uint64(2)) | c[j : j + nwin]
        anti |= comp[j : j + nwin] << np.uint64(2 * j)
    return np.minimum(sense, anti)[valid]


def distinct_np(seq: str | bytes, k: int) -> np.ndarray:
    """A query's distinct canonical words, sorted (uint64)."""
    return np.unique(canonical_np(encode(seq), k))


def canonical_torch(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical words int64 ``[..., n - k + 1]`` of base codes ``[..., n]``
    (uint8, every base ACGT; k <= 31 so that a word fits a signed int64)."""
    if not 1 <= k <= 31:
        raise ValueError("canonical_torch takes 1 <= k <= 31")
    n = codes.shape[-1]
    nwin = n - k + 1
    c = codes.to(torch.int64)
    sense = torch.zeros(codes.shape[:-1] + (nwin,), dtype=torch.int64, device=codes.device)
    anti = torch.zeros_like(sense)
    for j in range(k):
        win = c[..., j : j + nwin]
        sense = (sense << 2) | win
        anti |= (3 - win) << (2 * j)
    return torch.minimum(sense, anti)


def window_words(genomes: torch.Tensor, rows: torch.Tensor, starts: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Canonical words int64 of the windows ``genomes[rows, starts:starts+k]``
    (codes uint8 [R, G], every base ACGT; rows and starts int64, one shape)."""
    sense = torch.zeros(starts.shape, dtype=torch.int64, device=genomes.device)
    anti = torch.zeros_like(sense)
    for j in range(k):
        b = genomes[rows, starts + j].to(torch.int64)
        sense = (sense << 2) | b
        anti |= (3 - b) << (2 * j)
    return torch.minimum(sense, anti)
