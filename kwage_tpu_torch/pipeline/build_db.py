"""Filter -> bit-slice .db pack with the device transpose (PyTorch + CUDA
port of the device branch of kwage_tpu/pipeline/build_db.py).

The same streaming as the JAX module: every .bloom input is read in
lockstep in ``chunk_bits`` row chunks, each chunk is transposed, and the
per-filter crc32 is checked at the end (build_db.cpp:280-286, 343-362).
With a device, each chunk goes through the bit_transpose kernel
(``kwage_tpu_torch.ops.transpose``); without one, through the host
transpose ``kwage_tpu.pipeline.build_db.transpose_filters``. Both give the
reference's bytes.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from kwage_tpu.core.params import BloomParam
from kwage_tpu.io.binary import BinaryReader
from kwage_tpu.io.bloom_file import BLOOM_MAGIC_COMPLETE, read_bloom_file
from kwage_tpu.io.db_file import DBFileHeader, write_db_file_streaming
from kwage_tpu.pipeline.build_db import DEFAULT_CHUNK_BITS, transpose_filters

from ..ops.transpose import transpose_chunks_device
from ..utils.runtime import resolve_device


def _iter_transposed_chunks(
    paths: list[str], param: BloomParam, chunk_bits: int,
    device: torch.device | None,
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
