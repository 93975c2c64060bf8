""".db database file reader/writer (byte-exact with the reference).

Layout (kwage.h:30-72; build_db.cpp:188-429):
  header (44 bytes):
    u32 magic = 0x20191025, u32 version = 2, u32 crc32 (of the slice data),
    u32 kmer_len, u32 num_hash, u32 log_2_filter_len, u32 num_filter,
    i32 hash_func, u32 compression (0 = NO_COMPRESSION), u64 info_start
  2**L bit slices, each ceil(num_filter/8) bytes
    (slice row s bit j == Bloom filter j's bit s; bits LSB-first per byte)
  num_filter x u64 absolute offsets of the FilterInfo records
  num_filter FilterInfo records
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..core.info import FilterInfo
from ..core.params import BloomParam
from .binary import BinaryReader, BinaryWriter

KWAGE_MAGIC_NUMBER = 0x20191025
CURRENT_DBFILE_VERSION = 2

NO_COMPRESSION = 0
RLE_COMPRESSION = 1
RLE_HUFFMAN_COMPRESSION = 2

HEADER_SIZE = 44


@dataclass
class DBFileHeader:
    magic: int = KWAGE_MAGIC_NUMBER
    version: int = CURRENT_DBFILE_VERSION
    crc32: int = 0
    kmer_len: int = 0
    num_hash: int = 0
    log_2_filter_len: int = 0
    num_filter: int = 0
    hash_func: int = 0
    compression: int = NO_COMPRESSION
    info_start: int = 0

    @property
    def filter_len(self) -> int:
        return 1 << self.log_2_filter_len

    @property
    def slice_size(self) -> int:
        """Bytes per uncompressed bit slice (kwage.cpp:108-109)."""
        return (self.num_filter + 7) // 8

    @property
    def param(self) -> BloomParam:
        return BloomParam(
            kmer_len=self.kmer_len,
            log_2_filter_len=self.log_2_filter_len,
            num_hash=self.num_hash,
            hash_func=self.hash_func,
        )

    def pack(self) -> bytes:
        return struct.pack(
            "<IIIIIIIiIQ",
            self.magic,
            self.version,
            self.crc32,
            self.kmer_len,
            self.num_hash,
            self.log_2_filter_len,
            self.num_filter,
            self.hash_func,
            self.compression,
            self.info_start,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "DBFileHeader":
        vals = struct.unpack("<IIIIIIIiIQ", data[:HEADER_SIZE])
        hdr = cls(*vals)
        if hdr.magic != KWAGE_MAGIC_NUMBER:
            raise ValueError(f"bad database magic number {hdr.magic:#x}")
        return hdr


@dataclass
class DBFileReader:
    """Random-access reader over a .db file."""

    path: str
    header: DBFileHeader = field(init=False)

    def __post_init__(self) -> None:
        with open(self.path, "rb") as f:
            self.header = DBFileHeader.unpack(f.read(HEADER_SIZE))

    def read_slices(self) -> np.ndarray:
        """All bit slices as a uint8 matrix [filter_len, slice_size]."""
        h = self.header
        with open(self.path, "rb") as f:
            f.seek(HEADER_SIZE)
            data = f.read(h.filter_len * h.slice_size)
        return np.frombuffer(data, dtype=np.uint8).reshape(h.filter_len, h.slice_size)

    def mmap_slices(self) -> np.ndarray:
        """Memory-mapped view of the slice matrix [filter_len, slice_size].

        Pages fault in on first touch, so a search that visits few rows
        (the native kernel's complete-match early exit) reads only those
        pages -- the lazy-disk behavior of the reference's per-row seeks
        (kwage.cpp:415-424) without the per-row syscall cost.
        """
        h = self.header
        return np.memmap(
            self.path, dtype=np.uint8, mode="r", offset=HEADER_SIZE,
            shape=(h.filter_len, h.slice_size))

    def read_slice_rows(self, rows: np.ndarray) -> np.ndarray:
        """Gather specific slice rows -> uint8 [len(rows), slice_size]."""
        h = self.header
        out = np.empty((len(rows), h.slice_size), dtype=np.uint8)
        with open(self.path, "rb") as f:
            for i, r in enumerate(rows):
                f.seek(HEADER_SIZE + int(r) * h.slice_size)
                out[i] = np.frombuffer(f.read(h.slice_size), dtype=np.uint8)
        return out

    def read_filter_info(self, index: int) -> FilterInfo:
        h = self.header
        with open(self.path, "rb") as f:
            f.seek(h.info_start + index * 8)
            (loc,) = struct.unpack("<Q", f.read(8))
            f.seek(loc)
            return BinaryReader(f).filter_info()

    def read_all_filter_info(self) -> list[FilterInfo]:
        h = self.header
        with open(self.path, "rb") as f:
            f.seek(h.info_start)
            locs = struct.unpack(f"<{h.num_filter}Q", f.read(8 * h.num_filter))
            r = BinaryReader(f)
            out = []
            for loc in locs:
                f.seek(loc)
                out.append(r.filter_info())
        return out

    def verify_crc32(self) -> bool:
        h = self.header
        crc = zlib.crc32(b"")
        with open(self.path, "rb") as f:
            f.seek(HEADER_SIZE)
            remaining = h.filter_len * h.slice_size
            while remaining:
                chunk = f.read(min(remaining, 1 << 24))
                if not chunk:
                    return False
                crc = zlib.crc32(chunk, crc)
                remaining -= len(chunk)
        return (crc & 0xFFFFFFFF) == h.crc32


def write_db_file(
    path: str,
    param: BloomParam,
    slices: np.ndarray,
    infos: list[FilterInfo],
    num_filter: int | None = None,
) -> DBFileHeader:
    """Write a complete .db file from an in-memory slice matrix.

    ``slices`` is uint8 [filter_len, slice_size] (bit j of row s = filter j's
    bit s, LSB-first). Header is written twice (placeholder then patched with
    crc32/info_start), matching build_db.cpp:214, 421-423.
    """
    if num_filter is None:
        num_filter = len(infos)
    hdr = DBFileHeader(
        kmer_len=param.kmer_len,
        num_hash=param.num_hash,
        log_2_filter_len=param.log_2_filter_len,
        num_filter=num_filter,
        hash_func=param.hash_func,
        compression=NO_COMPRESSION,
    )
    if slices.shape != (hdr.filter_len, hdr.slice_size):
        raise ValueError(
            f"slice matrix shape {slices.shape} != ({hdr.filter_len}, {hdr.slice_size})"
        )

    with open(path, "wb") as f:
        f.write(hdr.pack())
        data = np.ascontiguousarray(slices).tobytes()
        f.write(data)
        hdr.crc32 = zlib.crc32(data) & 0xFFFFFFFF

        hdr.info_start = f.tell()
        f.write(b"\x00" * (8 * num_filter))

        w = BinaryWriter(f)
        locs = []
        for info in infos:
            locs.append(f.tell())
            w.filter_info(info)

        f.seek(hdr.info_start)
        f.write(struct.pack(f"<{num_filter}Q", *locs))

        f.seek(0)
        f.write(hdr.pack())
    return hdr


def write_db_file_streaming(
    path: str,
    param: BloomParam,
    slice_chunks,
    infos: list[FilterInfo],
    num_filter: int,
) -> DBFileHeader:
    """Write a .db file from an iterator of uint8 [chunk_rows, slice_size]
    chunks, keeping memory bounded like build_db.cpp:236-315."""
    hdr = DBFileHeader(
        kmer_len=param.kmer_len,
        num_hash=param.num_hash,
        log_2_filter_len=param.log_2_filter_len,
        num_filter=num_filter,
        hash_func=param.hash_func,
        compression=NO_COMPRESSION,
    )
    crc = zlib.crc32(b"")
    rows_written = 0
    with open(path, "wb") as f:
        f.write(hdr.pack())
        for chunk in slice_chunks:
            if chunk.shape[1] != hdr.slice_size:
                raise ValueError("bad slice chunk width")
            data = np.ascontiguousarray(chunk).tobytes()
            f.write(data)
            crc = zlib.crc32(data, crc)
            rows_written += chunk.shape[0]
        if rows_written != hdr.filter_len:
            raise ValueError(f"wrote {rows_written} slice rows, expected {hdr.filter_len}")
        hdr.crc32 = crc & 0xFFFFFFFF

        hdr.info_start = f.tell()
        f.write(b"\x00" * (8 * num_filter))
        w = BinaryWriter(f)
        locs = []
        for info in infos:
            locs.append(f.tell())
            w.filter_info(info)
        f.seek(hdr.info_start)
        f.write(struct.pack(f"<{num_filter}Q", *locs))
        f.seek(0)
        f.write(hdr.pack())
    return hdr
