""".dbz compressed database files (engine extension).

The reference reserves a ``compression`` header field and an aspirational
``.dbz`` extension (kwage.h:16-20; README.md mentions `.dbz`), measures
zlib ratios (~0.75, slice_z.h:162-167), but never defines or ships a
compressed on-disk layout: slice_z.h is dead code, build_db always writes
NO_COMPRESSION (build_db.cpp:197-199) and merge_db refuses anything else.
This module supplies the missing format:

  header           same 44-byte DBFileHeader layout, compression = 3
                   (ZLIB_CHUNKED; values 1-2 stay reserved for the
                   reference's unimplemented RLE modes), crc32 = crc of
                   the UNCOMPRESSED slice data (same value a .db of the
                   same content carries)
  u32  chunk_rows  slice rows per compressed chunk
  u64  num_chunks
  num_chunks x u64 compressed chunk byte sizes (a seek index)
  chunks           zlib streams of chunk_rows * slice_size bytes each
                   (final chunk truncated)
  info table + FilterInfo records, exactly as in .db (info_start in the
                   header points at the table)

Chunked framing keeps search seek-friendly: probing a slice row costs one
chunk inflate, and whole-file loads stream chunk by chunk.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..core.info import FilterInfo
from ..core.params import BloomParam
from .binary import BinaryReader, BinaryWriter
from .db_file import HEADER_SIZE, DBFileHeader

ZLIB_CHUNKED_COMPRESSION = 3
DEFAULT_CHUNK_ROWS = 1 << 16


@dataclass
class DBZFileReader:
    """Random-access reader over a .dbz file (DBFileReader-compatible)."""

    path: str
    header: DBFileHeader = field(init=False)

    def __post_init__(self) -> None:
        with open(self.path, "rb") as f:
            self.header = DBFileHeader.unpack(f.read(HEADER_SIZE))
            if self.header.compression != ZLIB_CHUNKED_COMPRESSION:
                raise ValueError(
                    f"not a zlib-chunked database (compression={self.header.compression})"
                )
            (self.chunk_rows,) = struct.unpack("<I", f.read(4))
            (num_chunks,) = struct.unpack("<Q", f.read(8))
            sizes = struct.unpack(f"<{num_chunks}Q", f.read(8 * num_chunks))
        self.chunk_sizes = list(sizes)
        base = HEADER_SIZE + 4 + 8 + 8 * num_chunks
        self.chunk_offsets = []
        for s in self.chunk_sizes:
            self.chunk_offsets.append(base)
            base += s
        self._cache: dict[int, np.ndarray] = {}

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_sizes)

    def _chunk(self, ci: int) -> np.ndarray:
        """One decompressed chunk as uint8 [rows, slice_size] (LRU-ish cache)."""
        cached = self._cache.get(ci)
        if cached is not None:
            return cached
        h = self.header
        with open(self.path, "rb") as f:
            f.seek(self.chunk_offsets[ci])
            raw = f.read(self.chunk_sizes[ci])
        data = zlib.decompress(raw)
        arr = np.frombuffer(data, dtype=np.uint8).reshape(-1, h.slice_size)
        if len(self._cache) >= 16:
            self._cache.pop(next(iter(self._cache)))
        self._cache[ci] = arr
        return arr

    def read_slices(self) -> np.ndarray:
        h = self.header
        out = np.empty((h.filter_len, h.slice_size), dtype=np.uint8)
        row = 0
        for ci in range(self.num_chunks):
            chunk = self._chunk(ci)
            out[row : row + chunk.shape[0]] = chunk
            row += chunk.shape[0]
        if row != h.filter_len:
            raise ValueError(f"decompressed {row} slice rows, expected {h.filter_len}")
        return out

    def read_slice_rows(self, rows: np.ndarray) -> np.ndarray:
        h = self.header
        out = np.empty((len(rows), h.slice_size), dtype=np.uint8)
        for i, r in enumerate(rows):
            ci, off = divmod(int(r), self.chunk_rows)
            out[i] = self._chunk(ci)[off]
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
        crc = zlib.crc32(b"")
        for ci in range(self.num_chunks):
            crc = zlib.crc32(self._chunk(ci).tobytes(), crc)
        return (crc & 0xFFFFFFFF) == self.header.crc32


def write_dbz_file_streaming(
    path: str,
    param: BloomParam,
    slice_chunks,
    infos: list[FilterInfo],
    num_filter: int,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    level: int = 6,
) -> DBFileHeader:
    """Write a .dbz from an iterator of uint8 [rows, slice_size] chunks.

    Incoming chunk boundaries are re-framed to ``chunk_rows``; memory stays
    bounded by one frame.
    """
    hdr = DBFileHeader(
        kmer_len=param.kmer_len,
        num_hash=param.num_hash,
        log_2_filter_len=param.log_2_filter_len,
        num_filter=num_filter,
        hash_func=param.hash_func,
        compression=ZLIB_CHUNKED_COMPRESSION,
    )
    frame_bytes = chunk_rows * hdr.slice_size
    crc = zlib.crc32(b"")
    sizes: list[int] = []
    rows_written = 0

    with open(path, "wb") as f:
        f.write(hdr.pack())
        f.write(struct.pack("<I", chunk_rows))
        num_chunks_pos = f.tell()
        f.write(struct.pack("<Q", 0))          # patched below
        expected_chunks = -(-hdr.filter_len // chunk_rows)
        sizes_pos = f.tell()
        f.write(b"\x00" * (8 * expected_chunks))

        pending = b""

        def flush(buf: bytes) -> None:
            nonlocal crc
            crc = zlib.crc32(buf, crc)
            z = zlib.compress(buf, level)
            sizes.append(len(z))
            f.write(z)

        for chunk in slice_chunks:
            if chunk.shape[1] != hdr.slice_size:
                raise ValueError("bad slice chunk width")
            rows_written += chunk.shape[0]
            pending += np.ascontiguousarray(chunk).tobytes()
            while len(pending) >= frame_bytes:
                flush(pending[:frame_bytes])
                pending = pending[frame_bytes:]
        if pending:
            flush(pending)
        if rows_written != hdr.filter_len:
            raise ValueError(f"wrote {rows_written} slice rows, expected {hdr.filter_len}")
        if len(sizes) != expected_chunks:
            raise ValueError("chunk count mismatch")
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

        f.seek(num_chunks_pos)
        f.write(struct.pack("<Q", len(sizes)))
        f.seek(sizes_pos)
        f.write(struct.pack(f"<{len(sizes)}Q", *sizes))
        f.seek(0)
        f.write(hdr.pack())
    return hdr


def open_database(path: str):
    """Open a .db or .dbz by sniffing the header's compression field."""
    from .db_file import DBFileReader, NO_COMPRESSION

    with open(path, "rb") as f:
        hdr = DBFileHeader.unpack(f.read(HEADER_SIZE))
    if hdr.compression == NO_COMPRESSION:
        return DBFileReader(path)
    if hdr.compression == ZLIB_CHUNKED_COMPRESSION:
        return DBZFileReader(path)
    raise ValueError(f"unsupported compression {hdr.compression} in {path}")
