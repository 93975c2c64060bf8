"""Database defragmentation (the reference's merge_db, merge_db.cpp:25-820).

Groups partially-filled .db files by Bloom shape, then repeatedly merges the
two smallest files of a group: the smaller file's filter columns are
appended to the larger file (bit-level column append), with any overflow
past the per-shape quota spilled into a rewritten second file. Source
crc32 values are verified while streaming; outputs are written to temp
files and renamed into place.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable

import numpy as np

from ..core.params import BloomParam, filters_per_file_quota
from ..io.binary import BinaryReader, BinaryWriter
from ..io.db_file import HEADER_SIZE, NO_COMPRESSION, DBFileHeader

_CHUNK_SLICES = 1024  # matches max_num_slice_per_buffer (merge_db.cpp:~420)


def _append_columns(dst_rows_bits, src_bits, offset):
    dst_rows_bits[:, offset : offset + src_bits.shape[1]] = src_bits
    return dst_rows_bits


def merge_database_files(
    file_large: str, file_small: str, max_num_filters: int, verbose: bool = True
) -> tuple[int, str]:
    """Merge file_small's columns into file_large (in place via temp+rename).

    Returns (remaining_filter_count, filename) for the file that is still
    below the quota, or (0, "") when the merged file is exactly full.
    """
    import sys

    f1 = open(file_large, "rb")
    f2 = open(file_small, "rb")
    h1 = DBFileHeader.unpack(f1.read(HEADER_SIZE))
    h2 = DBFileHeader.unpack(f2.read(HEADER_SIZE))

    if verbose:
        print(f"\t\t\tSrc 1 has {h1.num_filter} Bloom filters", file=sys.stderr)
        print(f"\t\t\tSrc 2 has {h2.num_filter} Bloom filters", file=sys.stderr)
        print(f"\t\t\tMax Bloom filters/file =  {max_num_filters}", file=sys.stderr)

    if (
        h1.log_2_filter_len != h2.log_2_filter_len
        or h1.num_hash != h2.num_hash
        or h1.kmer_len != h2.kmer_len
        or h1.hash_func != h2.hash_func
    ):
        raise ValueError("incompatible database files")
    if h1.compression != NO_COMPRESSION or h2.compression != NO_COMPRESSION:
        raise ValueError("compressed database files are not currently supported")
    if h1.num_filter >= max_num_filters or h2.num_filter >= max_num_filters:
        raise ValueError("database file has more than expected filters")

    has_remainder = (h1.num_filter + h2.num_filter) > max_num_filters
    dst_path_1 = file_large + ".tmp"
    dst_path_2 = file_small + ".tmp" if has_remainder else ""
    if os.path.exists(dst_path_1) or (has_remainder and os.path.exists(dst_path_2)):
        raise ValueError("temp database file already exists")

    d1 = DBFileHeader(**{**h1.__dict__})
    d2 = DBFileHeader(**{**h2.__dict__})
    d1.crc32 = zlib.crc32(b"")
    d2.crc32 = zlib.crc32(b"")
    d1.info_start = 0
    d2.info_start = 0
    if has_remainder:
        d1.num_filter = max_num_filters
        d2.num_filter = (h1.num_filter + h2.num_filter) - max_num_filters
        ret = (d2.num_filter, file_small)
    else:
        d1.num_filter = h1.num_filter + h2.num_filter
        d2.num_filter = 0
        ret = (d1.num_filter, file_large) if d1.num_filter < max_num_filters else (0, "")

    out1 = open(dst_path_1, "wb")
    out1.write(d1.pack())
    out2 = None
    if has_remainder:
        out2 = open(dst_path_2, "wb")
        out2.write(d2.pack())

    if verbose:
        print(f"\t\t\tDst 1 has {d1.num_filter} Bloom filters", file=sys.stderr)
        if has_remainder:
            print(f"\t\t\tDst 2 has {d2.num_filter} Bloom filters", file=sys.stderr)

    n_merge = h2.num_filter - d2.num_filter  # src-2 columns going into dst 1
    crc_src_1 = zlib.crc32(b"")
    crc_src_2 = zlib.crc32(b"")

    filter_len = h1.filter_len
    for start in range(0, filter_len, _CHUNK_SLICES):
        n = min(_CHUNK_SLICES, filter_len - start)
        b1 = f1.read(n * h1.slice_size)
        b2 = f2.read(n * h2.slice_size)
        crc_src_1 = zlib.crc32(b1, crc_src_1)
        crc_src_2 = zlib.crc32(b2, crc_src_2)

        rows1 = np.frombuffer(b1, dtype=np.uint8).reshape(n, h1.slice_size)
        rows2 = np.frombuffer(b2, dtype=np.uint8).reshape(n, h2.slice_size)
        bits2 = np.unpackbits(rows2, axis=1, bitorder="little")

        dst1 = np.zeros((n, d1.slice_size), dtype=np.uint8)
        dst1[:, : h1.slice_size] = rows1
        if h1.num_filter % 8 == 0:
            # Byte aligned: pack the appended columns directly.
            app = np.packbits(bits2[:, :n_merge], axis=1, bitorder="little")
            dst1[:, h1.slice_size : h1.slice_size + app.shape[1]] = app
        else:
            bits1 = np.unpackbits(dst1, axis=1, bitorder="little")
            bits1[:, h1.num_filter : h1.num_filter + n_merge] = bits2[:, :n_merge]
            dst1 = np.packbits(bits1[:, : d1.slice_size * 8], axis=1, bitorder="little")
        data1 = dst1.tobytes()
        out1.write(data1)
        d1.crc32 = zlib.crc32(data1, d1.crc32)

        if has_remainder:
            rem_bits = bits2[:, n_merge : n_merge + d2.num_filter]
            pad = (-rem_bits.shape[1]) % 8
            if pad:
                rem_bits = np.pad(rem_bits, ((0, 0), (0, pad)))
            data2 = np.packbits(rem_bits, axis=1, bitorder="little").tobytes()
            out2.write(data2)
            d2.crc32 = zlib.crc32(data2, d2.crc32)

    if (crc_src_1 & 0xFFFFFFFF) != h1.crc32:
        raise ValueError("invalid crc32 for source database file 1")
    if (crc_src_2 & 0xFFFFFFFF) != h2.crc32:
        raise ValueError("invalid crc32 for source database file 2")

    # Metadata: file-1 infos, then the merged prefix of file-2's, then the
    # remainder into file 2.
    d1.info_start = out1.tell()
    out1.write(b"\x00" * (8 * d1.num_filter))
    locs1 = []
    r1 = BinaryReader(f1)
    w1 = BinaryWriter(out1)
    f1.seek(h1.info_start + 8 * h1.num_filter)
    for _ in range(h1.num_filter):
        info = r1.filter_info()
        locs1.append(out1.tell())
        w1.filter_info(info)

    f2.seek(h2.info_start + 8 * h2.num_filter)
    r2 = BinaryReader(f2)
    for _ in range(n_merge):
        info = r2.filter_info()
        locs1.append(out1.tell())
        w1.filter_info(info)

    if has_remainder:
        d2.info_start = out2.tell()
        out2.write(b"\x00" * (8 * d2.num_filter))
        w2 = BinaryWriter(out2)
        locs2 = []
        for _ in range(d2.num_filter):
            info = r2.filter_info()
            locs2.append(out2.tell())
            w2.filter_info(info)
        out2.seek(0)
        out2.write(d2.pack())
        out2.seek(d2.info_start)
        out2.write(struct.pack(f"<{d2.num_filter}Q", *locs2))
        out2.close()

    out1.seek(0)
    out1.write(d1.pack())
    out1.seek(d1.info_start)
    out1.write(struct.pack(f"<{d1.num_filter}Q", *locs1))
    out1.close()
    f1.close()
    f2.close()

    os.rename(dst_path_1, file_large)
    if has_remainder:
        os.rename(dst_path_2, file_small)
    else:
        os.unlink(file_small)
    return ret


def merge_databases(paths: Iterable[str], verbose: bool = True) -> None:
    """Group by Bloom shape and pairwise-merge smallest-first (merge_db.cpp main)."""
    import sys

    headers: dict[str, DBFileHeader] = {}
    groups: dict[BloomParam, list[str]] = {}
    for path in paths:
        with open(path, "rb") as f:
            hdr = DBFileHeader.unpack(f.read(HEADER_SIZE))
        quota = filters_per_file_quota(hdr.log_2_filter_len)
        if quota <= hdr.num_filter:
            continue  # already full
        if path in headers:
            raise ValueError(f"{path} appears more than once in the input file list")
        headers[path] = hdr
        groups.setdefault(hdr.param, []).append(path)

    if verbose:
        print(f"Found {len(groups)} distinct Bloom parameter groups", file=sys.stderr)

    for gi, (param, files) in enumerate(sorted(groups.items(), key=lambda kv: kv[0])):
        db_files = sorted((headers[f].num_filter, f) for f in files)
        if verbose:
            print(f"Bloom parameters for group {gi} of {len(groups)}", file=sys.stderr)
            print(f"log_2_filter_len = {param.log_2_filter_len}", file=sys.stderr)
            print(f"num_hash = {param.num_hash}", file=sys.stderr)
        quota = filters_per_file_quota(param.log_2_filter_len)
        while len(db_files) > 1:
            _, file_small = db_files.pop(0)
            _, file_large = db_files.pop(0)
            if verbose:
                print(f"\tmerging:\n\t\t{file_small}\n\t\t{file_large}", file=sys.stderr)
            remainder = merge_database_files(file_large, file_small, quota, verbose)
            if remainder[0] > 0:
                db_files.append(remainder)
                db_files.sort()
