"""Seed-vectorised murmur3-32 over canonical k-mer words (PyTorch + CUDA
port of kwage_tpu/ops/hashing.py).

K-mer words are int64 tensors holding the 2k-bit canonical word (the
uint64 bit pattern; k = 32 fills all 64 bits). Hashes are int32 tensors
holding the uint32 bit patterns.

- ``murmur32``: the kernel wrapper. On a CUDA tensor it launches
  ``csrc/murmur.cu`` (or raises; it takes under 2^31 outputs, n x seeds);
  on a CPU tensor it runs ``murmur32_ref``.
- ``murmur32_ref``: the plain version, in int32 wrap arithmetic with
  masked logical shifts (torch has no uint32 arithmetic).
- ``slice_indices``: murmur masked to 2^L slice rows, one launch.
"""

from __future__ import annotations

import torch

from .. import kernels


def _i32(c: int) -> int:
    """A uint32 constant as the int32 of the same bits."""
    return c - (1 << 32) if c >= 1 << 31 else c


_C1, _C2, _C3 = _i32(0xCC9E2D51), _i32(0x1B873593), _i32(0xE6546B64)
_F1, _F2 = _i32(0x85EBCA6B), _i32(0xC2B2AE35)
_ACGT = (65, 67, 71, 84)


def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _srl(x, 32 - r)


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _rotl(k1 * _C1, 15) * _C2


def murmur32_ref(words: torch.Tensor, k: int, num_seeds: int) -> torch.Tensor:
    """Plain murmur3-32 of each k-mer for seeds 0..num_seeds-1 -> int32
    [n, num_seeds] (uint32 bit patterns)."""
    ascii_lut = torch.tensor(_ACGT, dtype=torch.int32, device=words.device)

    def base(i: int) -> torch.Tensor:  # ASCII of base i, 5' end first
        return ascii_lut[(words >> (2 * (k - 1 - i))) & 3]

    nblocks, tail = k // 4, k & 3
    h = torch.arange(num_seeds, dtype=torch.int32, device=words.device).expand(
        words.shape[0], num_seeds).contiguous()
    for blk in range(nblocks):
        k1 = torch.zeros(words.shape[0], dtype=torch.int32, device=words.device)
        for byte in range(4):
            k1 |= base(4 * blk + byte) << (8 * byte)
        h = _rotl(h ^ _mix_k1(k1)[:, None], 13) * 5 + _C3
    if tail:
        k1 = torch.zeros(words.shape[0], dtype=torch.int32, device=words.device)
        for t in range(tail):
            k1 ^= base(4 * nblocks + t) << (8 * t)
        h = h ^ _mix_k1(k1)[:, None]
    h = h ^ k
    h = (h ^ _srl(h, 16)) * _F1
    h = (h ^ _srl(h, 13)) * _F2
    return h ^ _srl(h, 16)


def _mask(log2_filter_len: int) -> int:
    return -1 if log2_filter_len >= 32 else (1 << log2_filter_len) - 1


def _launch_murmur(words: torch.Tensor, k: int, num_seeds: int, mask: int) -> torch.Tensor:
    if words.dim() != 1 or words.dtype != torch.int64:
        raise ValueError(f"expected int64 [n] words, got {words.dtype} {tuple(words.shape)}")
    if not 1 <= k <= 32 or num_seeds < 1:
        raise ValueError(f"need 1 <= k <= 32 and num_seeds >= 1 (k={k}, nh={num_seeds})")
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if words.shape[0] * num_seeds >= 1 << 31:
        raise ValueError(f"the kernel takes under 2^31 outputs ({words.shape[0]} x {num_seeds})")
    words = words.contiguous()
    out = torch.empty((words.shape[0], num_seeds), dtype=torch.int32, device=words.device)
    if words.numel():
        with torch.cuda.device(words.device):
            kernels.launch("murmur32", words.data_ptr(), out.data_ptr(), words.shape[0],
                           k, num_seeds, mask & 0xFFFFFFFF,
                           torch.cuda.current_stream(words.device).cuda_stream)
    return out


def murmur32(words: torch.Tensor, k: int, num_seeds: int) -> torch.Tensor:
    """Murmur3-32 of int64 k-mer words [n] for seeds 0..num_seeds-1 ->
    int32 [n, num_seeds]. CUDA tensor: the murmur32 kernel; CPU tensor:
    murmur32_ref."""
    if words.device.type == "cpu":
        return murmur32_ref(words, k, num_seeds)
    return _launch_murmur(words, k, num_seeds, -1)


def slice_indices(words: torch.Tensor, k: int, num_hash: int,
                  log2_filter_len: int) -> torch.Tensor:
    """Per-(k-mer, seed) slice rows murmur & (2^L - 1) -> int32 [n, num_hash]
    (at L = 32 the int32 bit patterns of the full hash, as the JAX
    version's astype gives)."""
    if words.device.type == "cpu":
        return murmur32_ref(words, k, num_hash) & _mask(log2_filter_len)
    return _launch_murmur(words, k, num_hash, _mask(log2_filter_len))
