"""Canonical k-mer extraction on the device (PyTorch + CUDA port of
kwage_tpu/ops/kmers.py).

A k-mer word is one int64 holding the 2k-bit canonical word (the unsigned
minimum of the sense and reverse-complement windows; at k = 32 the sign
bit is a word bit). The JAX package splits it into (hi, lo) uint32 pairs
because the TPU's lanes are 32-bit; ``words_to_u64`` / ``u64_to_words``
convert between the two at the numpy boundary.

- ``canonical_kmers_packed``: the kernel wrapper over 2-bit packed reads
  (``pack_reads_host`` layout). CUDA tensor: ``csrc/kmers.cu``; CPU
  tensor: ``canonical_kmers_packed_ref``.
- ``canonical_kmers``: ASCII input, decoded on the tensor's device. CUDA
  tensor: the same kernel through its ASCII entry; CPU tensor:
  ``canonical_kmers_ascii_ref``. Non-ACGT bytes give invalid windows in
  either layout.
- numpy twins of the JAX module's host helpers, which cannot be imported
  from there (``kwage_tpu.ops.kmers`` imports jax at module scope).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .search import words_to_tensor

_SIGN = -(1 << 63)


# --- host helpers (numpy; the JAX module's twins) ---------------------------

def pack_reads_host(batch_ascii) -> tuple[np.ndarray, np.ndarray]:
    """2-bit packing of a padded ASCII read batch uint8 [R, L] ->
    (packed uint32 [R, ceil(L/16)], valid uint32 [R, ceil(L/32)]): 16
    bases a word, 2 bits each, LSB-first; one validity bit a base."""
    b = np.asarray(batch_ascii, dtype=np.uint8)
    lut_code = np.zeros(256, np.uint8)
    lut_valid = np.zeros(256, bool)
    for ch, v in ((65, 0), (97, 0), (67, 1), (99, 1), (71, 2), (103, 2), (84, 3), (116, 3)):
        lut_code[ch] = v
        lut_valid[ch] = True
    R, L = b.shape
    L16, L32 = -(-L // 16) * 16, -(-L // 32) * 32
    c = np.zeros((R, L16), np.uint32)
    c[:, :L] = lut_code[b]
    packed = (c.reshape(R, -1, 16) << (2 * np.arange(16, dtype=np.uint32))).sum(
        axis=2, dtype=np.uint32)
    v = np.zeros((R, L32), np.uint32)
    v[:, :L] = lut_valid[b]
    valid_words = (v.reshape(R, -1, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32)
    return packed, valid_words


def words_to_u64(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 pairs -> numpy uint64 words (host)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


def u64_to_words(words) -> tuple[np.ndarray, np.ndarray]:
    """numpy uint64 -> (hi, lo) uint32 pairs (host)."""
    w = np.asarray(words, dtype=np.uint64)
    return (w >> np.uint64(32)).astype(np.uint32), (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def words_u64_to_tensor(words_u64: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint64 numpy k-mer words -> int64 tensor of the same bits on ``device``."""
    arr = np.ascontiguousarray(words_u64, dtype=np.uint64).view(np.int64)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def tensor_to_words_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of k-mer words -> uint64 numpy array (host)."""
    return np.ascontiguousarray(t.cpu().numpy()).view(np.uint64)


# --- plain PyTorch version ----------------------------------------------------

def unsigned_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b on int64 tensors read as uint64."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _canonical_from_codes_ref(codes: torch.Tensor, base_ok: torch.Tensor,
                              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes int64 [R, L] and base validity bool [R, L] -> (canonical
    words, valid) [R, L-k+1]: the k shifted codes of every window summed."""
    nwin = codes.shape[1] - k + 1
    sense = torch.zeros((codes.shape[0], nwin), dtype=torch.int64, device=codes.device)
    anti = torch.zeros_like(sense)
    for i in range(k):
        c = codes[:, i : i + nwin]
        sense |= c << (2 * (k - 1 - i))
        anti |= (3 - c) << (2 * i)
    bad = torch.cumsum(torch.nn.functional.pad((~base_ok).int(), (1, 0)), dim=1)
    valid = (bad[:, k:] - bad[:, :-k]) == 0
    return torch.where(unsigned_lt(anti, sense), anti, sense), valid


def canonical_kmers_packed_ref(packed: torch.Tensor, valid_words: torch.Tensor,
                               k: int, length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``canonical_kmers_packed`` for [R, w] inputs:
    unpack the codes, then the windows."""
    pos = torch.arange(length, device=packed.device)
    codes = (packed[:, pos // 16] >> (2 * (pos % 16))) & 3                # int32 [R, L]
    base_ok = ((valid_words[:, pos // 32] >> (pos % 32)) & 1) != 0
    return _canonical_from_codes_ref(codes.long(), base_ok, k)


def canonical_kmers_ascii_ref(ascii_u8: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``canonical_kmers`` for uint8 [R, n]: A/C/G/T in
    either case are the codes 0-3, any other byte is code 0 and invalid
    (``encode_bases_device``), then the windows."""
    x = ascii_u8.long()
    codes = torch.zeros_like(x)
    base_ok = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for value, (upper, lower) in enumerate(((65, 97), (67, 99), (71, 103), (84, 116))):
        hit = (x == upper) | (x == lower)
        codes = torch.where(hit, value, codes)
        base_ok |= hit
    return _canonical_from_codes_ref(codes, base_ok, k)


# --- kernel wrapper -----------------------------------------------------------

def canonical_kmers_packed(packed: torch.Tensor, valid_words: torch.Tensor,
                           k: int, length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """2-bit packed reads int32 [R, ceil(length/16)] and their valid bits
    int32 [R, ceil(length/32)] -> (canonical words int64 [R, nwin], valid
    bool [R, nwin]), nwin = length - k + 1; 1-D inputs (one read) give
    1-D outputs. CUDA tensors: the canonical_kmers kernel; CPU tensors:
    canonical_kmers_packed_ref."""
    if not 1 <= k <= 32:
        raise ValueError(f"need 1 <= k <= 32, got {k}")
    if length < k:
        raise ValueError("sequence shorter than k")
    one = packed.dim() == 1
    if one:
        packed, valid_words = packed[None], valid_words[None]
    if packed.dtype != torch.int32 or valid_words.dtype != torch.int32:
        raise ValueError("expected int32 packed and valid words")
    R = packed.shape[0]
    if (valid_words.shape[0] != R or packed.shape[1] * 16 < length
            or valid_words.shape[1] * 32 < length):
        raise ValueError(f"packed {tuple(packed.shape)} / valid {tuple(valid_words.shape)} "
                         f"do not hold {length} bases")
    if packed.device != valid_words.device:
        raise ValueError("packed and valid words must share a device")
    if packed.device.type == "cpu":
        words, valid = canonical_kmers_packed_ref(packed, valid_words, k, length)
    elif packed.device.type == "cuda":
        packed, valid_words = packed.contiguous(), valid_words.contiguous()
        nwin = length - k + 1
        words = torch.empty((R, nwin), dtype=torch.int64, device=packed.device)
        valid = torch.empty((R, nwin), dtype=torch.bool, device=packed.device)
        if words.numel():
            with torch.cuda.device(packed.device):
                kernels.launch(
                    "canonical_kmers", packed.data_ptr(), valid_words.data_ptr(),
                    words.data_ptr(), valid.data_ptr(), R, packed.shape[1],
                    valid_words.shape[1], length, k,
                    torch.cuda.current_stream(packed.device).cuda_stream)
    else:
        raise ValueError(f"unsupported device {packed.device}")
    return (words[0], valid[0]) if one else (words, valid)


def pack_to_device(batch_ascii: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host 2-bit pack of an ASCII batch uint8 [R, L], uploaded as int32."""
    packed, valid_words = pack_reads_host(batch_ascii)
    return words_to_tensor(packed, device), words_to_tensor(valid_words, device)


def canonical_kmers(ascii_u8: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """All k-windows of ASCII sequence(s) uint8 [n] or [R, n] -> (canonical
    words int64, valid bool), [n-k+1] or [R, n-k+1], on ``ascii_u8``'s
    device. CUDA tensors: the canonical_kmers kernel, decoding the bytes on
    the card; CPU tensors: canonical_kmers_ascii_ref."""
    if not 1 <= k <= 32:
        raise ValueError(f"need 1 <= k <= 32, got {k}")
    if ascii_u8.dtype != torch.uint8:
        raise ValueError(f"expected uint8 ASCII, got {ascii_u8.dtype}")
    one = ascii_u8.dim() == 1
    batch = ascii_u8.reshape(1, -1) if one else ascii_u8
    R, length = batch.shape
    if length < k:
        raise ValueError("sequence shorter than k")
    if batch.device.type == "cpu":
        words, valid = canonical_kmers_ascii_ref(batch, k)
    elif batch.device.type == "cuda":
        batch = batch.contiguous()
        nwin = length - k + 1
        words = torch.empty((R, nwin), dtype=torch.int64, device=batch.device)
        valid = torch.empty((R, nwin), dtype=torch.bool, device=batch.device)
        if words.numel():
            with torch.cuda.device(batch.device):
                kernels.launch(
                    "canonical_kmers_ascii", batch.data_ptr(), words.data_ptr(),
                    valid.data_ptr(), R, length, length, k,
                    torch.cuda.current_stream(batch.device).cuda_stream)
    else:
        raise ValueError(f"unsupported device {batch.device}")
    return (words[0], valid[0]) if one else (words, valid)
