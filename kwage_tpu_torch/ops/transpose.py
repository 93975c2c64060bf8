"""Device filter -> bit-slice transpose (PyTorch + CUDA port of
kwage_tpu/ops/transpose.py).

- ``packed_bit_transpose``: the kernel wrapper. On a CUDA tensor it
  launches ``csrc/bit_transpose.cu`` (or raises); on a CPU tensor it runs
  the plain version below.
- ``packed_bit_transpose_ref``: the plain PyTorch version, independent of
  any swap network: unpack the bits, transpose, pack.
- ``transpose_chunks_device``: the full .db transpose of packed filter
  bytes, streamed through the device in row chunks.

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
