"""Filter -> bit-slice .db pack with the device transpose (PyTorch + CUDA
port of the device branch of kwage_tpu/pipeline/build_db.py).

The same streaming as the JAX module: every .bloom input is read in
lockstep in ``chunk_bits`` row chunks, each chunk is transposed, and the
per-filter crc32 is checked at the end (build_db.cpp:280-286, 343-362).
With a device, each chunk goes through the bit_transpose kernel
(``kwage_tpu_torch.ops.transpose``); without one, through the host
transpose ``transpose_filters`` (the native 64x64-bit-block transpose, or
numpy). Both give the reference's bytes.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..core.params import BloomParam
from ..io.binary import BinaryReader
from ..io.bloom_file import BLOOM_MAGIC_COMPLETE, read_bloom_file
from ..io.db_file import DBFileHeader, write_db_file_streaming
from ..ops.transpose import transpose_chunks_device
from ..utils.runtime import resolve_device

# 1 GiB destination buffer in the reference (build_db.cpp:243); the numpy
# path is not seek-bound so a smaller default keeps memory modest.
# 2^21 bits (256 KB per filter per chunk), not 2^22: past ~256 KB row
# stride the native transpose's per-j-sweep source working set outgrows
# the (huge-page) TLB and throughput drops 2.6x (kwage_tpu's measurement
# on its development host's CPU: 609/517/514/198 MB/s at 2^18/20/21/22;
# not taken again for the port) -- and the block buffer at
# quota width (2048 filters) stays 512 MB instead of 1 GiB. Production-L
# filters (L >= 22) stream in multiple chunks; L <= 21 is one chunk
# either way.
DEFAULT_CHUNK_BITS = 1 << 21


def transpose_filters(filter_bytes: np.ndarray, num_filter: int | None = None) -> np.ndarray:
    """Transpose packed filters [F, L/8] -> packed slices [L, ceil(F/8)].

    Bits are LSB-first within each byte on both sides (bloom.h:140-171).
    Native 64x64-bit-block path when the library is present (~50x the
    numpy unpack/transpose/pack below, which was the dominant cost of
    every 2048-filter .db pack); the numpy path is the fallback twin.
    """
    F, nbytes = filter_bytes.shape
    if num_filter is None:
        num_filter = F
    if num_filter < F:
        raise ValueError(f"num_filter ({num_filter}) < source rows ({F})")
    from ..native import transpose_bits_native

    out = transpose_bits_native(filter_bytes, num_filter)
    if out is not None:
        return out
    # [F, L] bits; unpackbits is MSB-first, so request little-endian order.
    bits = np.unpackbits(filter_bytes, axis=1, bitorder="little")
    slices = np.packbits(bits.T, axis=1, bitorder="little")
    want = (num_filter + 7) // 8
    if slices.shape[1] < want:
        slices = np.pad(slices, ((0, 0), (0, want - slices.shape[1])))
    return slices


def _iter_transposed_chunks(
    paths: list[str], param: BloomParam, chunk_bits: int,
    device: torch.device | None = None,
):
    """Yield transposed slice chunks while streaming all inputs in lockstep,
    validating per-filter crc32."""
    num_filter = len(paths)
    filter_len = param.filter_len
    handles = []
    expected_crc = []
    running_crc = []
    try:
        for p in paths:
            f = open(p, "rb")
            handles.append(f)
            r = BinaryReader(f)
            if r.u8() != BLOOM_MAGIC_COMPLETE:
                raise ValueError(f"{p}: incomplete Bloom filter")
            local = r.bloom_param()
            if local != param:
                raise ValueError(f"{p}: inconsistent Bloom parameters {local} != {param}")
            expected_crc.append(r.u32())
            r.filter_info()  # skip; re-read separately for the metadata block
            running_crc.append(zlib.crc32(b""))

        for start in range(0, filter_len, chunk_bits):
            nbits = min(chunk_bits, filter_len - start)
            nbytes = nbits // 8
            block = np.empty((num_filter, nbytes), dtype=np.uint8)
            for j, f in enumerate(handles):
                data = f.read(nbytes)
                if len(data) != nbytes:
                    raise ValueError(f"{paths[j]}: truncated filter data")
                running_crc[j] = zlib.crc32(data, running_crc[j])
                block[j] = np.frombuffer(data, dtype=np.uint8)
            if device is None:
                yield transpose_filters(block, num_filter)
            else:
                yield transpose_chunks_device(block, device, chunk_bits=nbits)

        for j in range(num_filter):
            if (running_crc[j] & 0xFFFFFFFF) != expected_crc[j]:
                raise ValueError(f"{paths[j]}: invalid Bloom filter crc32")
    finally:
        for f in handles:
            f.close()


def build_db_from_bloom_files(
    out_path: str,
    param: BloomParam,
    bloom_files: list[str],
    chunk_bits: int = DEFAULT_CHUNK_BITS,
    device: bool | torch.device = False,
) -> DBFileHeader:
    """Transpose .bloom files into a .db database file (build_db.cpp:24-456).

    ``device``: False packs on the host; True packs on ``resolve_device()``
    (KWAGE_TORCH_DEVICE); a ``torch.device`` packs there. Output bytes are
    the same either way.
    """
    if not bloom_files:
        raise ValueError("empty Bloom filter inventory")
    if chunk_bits % 8:
        raise ValueError("chunk_bits must be byte aligned")
    if device is True:
        device = resolve_device()
    elif device is False:
        device = None
    infos = [read_bloom_file(p, with_bits=False).info for p in bloom_files]
    return write_db_file_streaming(
        out_path,
        param,
        _iter_transposed_chunks(bloom_files, param, chunk_bits, device),
        infos,
        num_filter=len(bloom_files),
    )


def build_dbz_from_bloom_files(
    out_path: str,
    param: BloomParam,
    bloom_files: list[str],
    chunk_bits: int = DEFAULT_CHUNK_BITS,
    level: int = 6,
) -> DBFileHeader:
    """Transpose .bloom files into a compressed .dbz database file.

    Engine extension (the reference reserves the header field and the
    .dbz name but never implements compression; see io/dbz_file.py).
    Searching a .dbz yields hit lists identical to the equivalent .db.
    """
    from ..io.dbz_file import write_dbz_file_streaming

    if not bloom_files:
        raise ValueError("empty Bloom filter inventory")
    if chunk_bits % 8:
        raise ValueError("chunk_bits must be byte aligned")

    infos = [read_bloom_file(p, with_bits=False).info for p in bloom_files]
    return write_dbz_file_streaming(
        out_path,
        param,
        _iter_transposed_chunks(bloom_files, param, chunk_bits),
        infos,
        num_filter=len(bloom_files),
        level=level,
    )
