"""KWAGE's uncompressed .db file, frozen (kwage.h:30-72, build_db.cpp:188-429).

  header, 44 bytes: u32 magic 0x20191025, u32 version 2, u32 crc32 of the
    slices, u32 kmer_len, u32 num_hash, u32 log_2_filter_len, u32
    num_filter, i32 hash_func (0: murmur3-32), u32 compression (0), u64
    info_start
  2^L slices of ceil(num_filter / 8) bytes (slice s, bit j LSB-first: filter
    j's bit s)
  num_filter u64 offsets of the FilterInfo records, then the records
    (bloom.h:478-496): u64 run, u64 experiment, 7 strings, u64 sample, a
    string, u64 attribute count, u64 study, 2 strings, u64 spots, u64 bases,
    3 x u32 date; strings NUL-terminated.

The benchmark writes its corpus with this file and reads the slices back
for its reference; it imports nothing of the program under test.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC, VERSION, HEADER = 0x20191025, 2, 44
_HEADER = "<IIIIIIIiIQ"


def accession_code(acc: str) -> int:
    """SRA accession ("SRR1234567") as KWAGE's packed u64
    (sra_accession.cpp:27-96): low 4 bits digits - 1, above them
    ((L0 * 26 + L1) * 26 + L2) * 10^digits + number."""
    letters, digits = acc[:3], acc[3:]
    data = ((ord(letters[0]) - 65) * 26 + ord(letters[1]) - 65) * 26 + ord(letters[2]) - 65
    return (len(digits) - 1) | ((data * 10 ** len(digits) + int(digits)) << 4)


def info_records(accessions: list[str]) -> list[bytes]:
    """A FilterInfo record a run: its accession, every other field empty."""
    tail = (b"\x00" * 7 + struct.pack("<Q", 0) + b"\x00" + struct.pack("<QQ", 0, 0)
            + b"\x00\x00" + struct.pack("<QQIII", 0, 0, 0, 0, 0))
    return [struct.pack("<QQ", accession_code(a), 0) + tail for a in accessions]


def write(path: str, k: int, num_hash: int, log2_len: int, slices: np.ndarray,
          accessions: list[str]) -> None:
    """One .db file of ``slices`` (uint8 [2^L, ceil(F / 8)]) and F runs."""
    num_filter = len(accessions)
    if slices.shape != (1 << log2_len, (num_filter + 7) // 8):
        raise ValueError(f"slices {slices.shape} do not fit {num_filter} filters at L={log2_len}")
    data = memoryview(np.ascontiguousarray(slices)).cast("B")
    info_start = HEADER + len(data)
    records = info_records(accessions)
    offsets, at = [], info_start + 8 * num_filter
    for r in records:
        offsets.append(at)
        at += len(r)
    header = struct.pack(_HEADER, MAGIC, VERSION, zlib.crc32(data) & 0xFFFFFFFF, k, num_hash,
                         log2_len, num_filter, 0, 0, info_start)
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)
        f.write(struct.pack(f"<{num_filter}Q", *offsets))
        f.write(b"".join(records))


def read_slices(path: str) -> np.ndarray:
    """A file's slices, uint8 [2^L, ceil(num_filter / 8)]."""
    with open(path, "rb") as f:
        magic, _, _, _, _, log2_len, num_filter, _, comp, _ = struct.unpack(
            _HEADER, f.read(HEADER))
    if magic != MAGIC or comp != 0:
        raise ValueError(f"{path}: not an uncompressed .db file")
    width = (num_filter + 7) // 8
    return np.fromfile(path, dtype=np.uint8, count=width << log2_len,
                       offset=HEADER).reshape(1 << log2_len, width)
