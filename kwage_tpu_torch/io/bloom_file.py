""".bloom file reader/writer (byte-exact with the reference).

Layout (binary_io.cpp:182-237):
  [u8 magic: 0x00 while being written, patched to 0xFF on completion]
  [BloomParam: u32 kmer_len, u32 log_2_filter_len, u32 num_hash, i32 hash_func]
  [u32 crc32 of the raw filter bits]
  [FilterInfo record]
  [raw filter bits: 2**L / 8 bytes, bit i stored at byte i//8, bit i%8]
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from ..core.info import FilterInfo
from ..core.params import BloomParam
from .binary import BinaryReader, BinaryWriter

BLOOM_MAGIC_IN_PROGRESS = 0x00
BLOOM_MAGIC_COMPLETE = 0xFF


@dataclass
class BloomFilterRecord:
    param: BloomParam
    crc32: int
    info: FilterInfo
    bits: np.ndarray  # uint8 byte array, LSB-first bit packing

    @property
    def num_bits(self) -> int:
        return self.param.filter_len

    def computed_crc32(self) -> int:
        return zlib.crc32(self.bits.tobytes()) & 0xFFFFFFFF

    def test_crc32(self) -> bool:
        return self.crc32 == self.computed_crc32()

    def get_bit(self, index: int) -> bool:
        return bool((int(self.bits[index >> 3]) >> (index & 7)) & 1)

    def count(self) -> int:
        return int(np.unpackbits(self.bits).sum())


def read_bloom_file(path: str, with_bits: bool = True) -> BloomFilterRecord:
    with open(path, "rb") as f:
        r = BinaryReader(f)
        magic = r.u8()
        if magic != BLOOM_MAGIC_COMPLETE:
            raise ValueError(f"{path}: Bloom filter record is not complete")
        param = r.bloom_param()
        crc = r.u32()
        info = r.filter_info()
        nbytes = param.filter_len // 8
        if with_bits:
            bits = np.frombuffer(r.read(nbytes), dtype=np.uint8).copy()
        else:
            bits = np.empty(0, dtype=np.uint8)
    return BloomFilterRecord(param=param, crc32=crc, info=info, bits=bits)


def write_bloom_file(path: str, rec: BloomFilterRecord) -> None:
    """Write a .bloom file, patching the completion magic byte at the end.

    Mirrors the in-progress/complete protocol of binary_write<BloomFilter>
    (binary_io.cpp:182-211) so a crashed writer leaves a detectable
    partial file.
    """
    with open(path, "wb") as f:
        w = BinaryWriter(f)
        w.u8(BLOOM_MAGIC_IN_PROGRESS)
        w.bloom_param(rec.param)
        w.u32(rec.crc32)
        w.filter_info(rec.info)
        f.write(rec.bits.tobytes())
        f.seek(0)
        w.u8(BLOOM_MAGIC_COMPLETE)
