"""Device filter -> bit-slice transpose (PyTorch + CUDA port of
kwage_tpu/ops/transpose.py).

- ``packed_bit_transpose``: the kernel wrapper. On a CUDA tensor it
  launches ``csrc/bit_transpose.cu`` (or raises); on a CPU tensor it runs
  the plain version below.
- ``packed_bit_transpose_ref``: the plain PyTorch version, independent of
  any swap network: unpack the bits, transpose, pack.
- ``transpose_chunks_device``: the full .db transpose of packed filter
  bytes, streamed through the device in row chunks.
- ``transpose_bits_device``: the byte entry, packed filters uint8 [F, B] ->
  packed slices uint8 [B*8, P/8]. Little-endian bytes viewed as 32-bit
  words are the same LSB-first bit matrix, so on a CUDA tensor it pads to
  whole words and goes through the bit_transpose kernel; its plain
  version, ``transpose_bits_ref``, is the unpack -> transpose -> pack
  formulation (``unpack_bits_u8`` / ``pack_bits_u8``), the cross-check it
  is in the JAX module.

Packed words live in int32 tensors as uint32 bit patterns (torch has no
uint32 arithmetic); ``.view(np.uint32)`` converts at the numpy boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def pack_filters_to_words(filter_bytes: np.ndarray) -> np.ndarray:
    """Host helper: packed filter bytes [F, L/8] -> uint32 words [F, ceil(L/32)]."""
    F, B = filter_bytes.shape
    pad = (-B) % 4
    if pad:
        filter_bytes = np.pad(filter_bytes, ((0, 0), (0, pad)))
    return np.ascontiguousarray(filter_bytes).reshape(F, -1, 4).view(np.uint32).reshape(F, -1)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 uint8 [..., 32*n] -> int32 words [..., n], bit i of word j =
    bits[..., 32j + i] (LSB-first)."""
    grouped = bits.reshape(*bits.shape[:-1], -1, 32)
    out = torch.zeros(grouped.shape[:-1], dtype=torch.int32, device=bits.device)
    for i in range(32):
        out |= grouped[..., i].to(torch.int32) << i
    return out


def packed_bit_transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch transpose: int32 [F, W] (F % 32 == 0) -> [W*32, F//32],
    bit (f, l) -> (l, f). Unpacks to one byte per bit (8x the input)."""
    F, W = x.shape
    if F % 32:
        raise ValueError("packed_bit_transpose_ref requires F % 32 == 0")
    bits = torch.empty((F, W, 32), dtype=torch.uint8, device=x.device)
    for b in range(32):
        bits[:, :, b] = (x >> b) & 1
    return _pack_bits(bits.reshape(F, W * 32).t().contiguous())


def packed_bit_transpose(x: torch.Tensor) -> torch.Tensor:
    """Packed transpose int32 [F, W] -> [W*32, ceil(F/32)] (bit (f,l) ->
    (l,f)); rows past F are zero-padded to a multiple of 32.

    CUDA tensor: the bit_transpose kernel. CPU tensor: the plain version.
    """
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"expected int32 [F, W], got {x.dtype} {tuple(x.shape)}")
    F, W = x.shape
    pad_f = (-F) % 32
    if pad_f:
        x = torch.cat([x, x.new_zeros((pad_f, W))])
    if x.device.type == "cpu":
        return packed_bit_transpose_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    Fp = x.shape[0]
    out = torch.empty((W * 32, Fp // 32), dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        kernels.launch(
            "bit_transpose", x.data_ptr(), out.data_ptr(), Fp, W,
            torch.cuda.current_stream(x.device).cuda_stream)
    return out


def transpose_chunks_device(
    filter_bytes: np.ndarray, device: torch.device, chunk_bits: int = 1 << 20
) -> np.ndarray:
    """Full transpose of packed filters [F, L/8] -> packed slices
    [L, ceil(F/8)], streamed through ``device`` in chunk_bits row chunks."""
    F, nbytes = filter_bytes.shape
    L = nbytes * 8
    width = (F + 7) // 8
    chunk_bytes = max(4, chunk_bits // 8 // 4 * 4)
    out = np.empty((L, width), dtype=np.uint8)
    for start in range(0, nbytes, chunk_bytes):
        stop = min(start + chunk_bytes, nbytes)
        words = pack_filters_to_words(filter_bytes[:, start:stop])
        res = packed_bit_transpose(torch.from_numpy(words.view(np.int32)).to(device))
        res_host = res.cpu().numpy().view("<u4")
        res_bytes = res_host.view(np.uint8).reshape(res_host.shape[0], -1)
        out[start * 8 : stop * 8] = res_bytes[: (stop - start) * 8, :width]
    return out


def unpack_bits_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [..., B] -> uint8 bits [..., B*8], LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x[..., None] >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8)


def pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [..., N] (N % 8 == 0) -> packed uint8 [..., N/8], LSB-first."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    return (grouped << shifts).sum(dim=-1, dtype=torch.uint8)


def transpose_bits_ref(filters: torch.Tensor, num_filter_padded: int) -> torch.Tensor:
    """Plain transpose_bits_device: unpack every bit to a byte, transpose,
    zero-pad the columns to num_filter_padded, pack."""
    F = filters.shape[0]
    bits_t = unpack_bits_u8(filters).t()
    if num_filter_padded > F:
        bits_t = torch.cat([bits_t, bits_t.new_zeros((bits_t.shape[0], num_filter_padded - F))],
                           dim=1)
    return pack_bits_u8(bits_t.contiguous())


def transpose_bits_device(filters: torch.Tensor, num_filter_padded: int) -> torch.Tensor:
    """Packed filters uint8 [F, B] -> packed slices uint8 [B*8, P/8].

    ``num_filter_padded`` (P, a multiple of 8, >= F) sets the output slice
    width; columns past F are zero. Matches the LSB-first layout of the
    .db format. CUDA tensor: the bit_transpose kernel on the bytes viewed
    as words; CPU tensor: transpose_bits_ref.
    """
    if filters.dim() != 2 or filters.dtype != torch.uint8:
        raise ValueError(f"expected uint8 [F, B], got {filters.dtype} {tuple(filters.shape)}")
    F, B = filters.shape
    P = num_filter_padded
    if P % 8 or P < F:
        raise ValueError(f"num_filter_padded must be a multiple of 8 and >= {F}, not {P}")
    if filters.device.type == "cpu":
        return transpose_bits_ref(filters, P)
    if filters.device.type != "cuda":
        raise ValueError(f"unsupported device {filters.device}")
    Fp, Bp = F + (-F) % 32, B + (-B) % 4
    if (Fp, Bp) != (F, B):
        padded = filters.new_zeros((Fp, Bp))
        padded[:F, :B] = filters
        filters = padded
    words = packed_bit_transpose(filters.contiguous().view(torch.int32))   # [Bp*8, Fp/32]
    slices = words.view(torch.uint8)[: B * 8]                              # [B*8, Fp/8]
    if P <= Fp:
        return slices[:, : P // 8].contiguous()
    out = slices.new_zeros((B * 8, P // 8))
    out[:, : Fp // 8] = slices
    return out
