"""Binary SRA inventory file (sra_inventory.cpp:400-428).

Layout: [u64 count] followed by ``count`` FilterInfo records.

``scan_inventory_locations`` reproduces parse_accession_loc
(file_io.cpp:23-118): it builds a (run_accession -> file offset) index,
sorted by accession, without holding all records in memory.
"""

from __future__ import annotations

import struct
from typing import Iterable

from ..core.info import FilterInfo
from .binary import BinaryReader, BinaryWriter


def write_inventory(path: str, infos: Iterable[FilterInfo]) -> int:
    infos = list(infos)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(infos)))
        w = BinaryWriter(f)
        for info in infos:
            w.filter_info(info)
    return len(infos)


def read_inventory(path: str) -> list[FilterInfo]:
    with open(path, "rb") as f:
        (count,) = struct.unpack("<Q", f.read(8))
        r = BinaryReader(f)
        return [r.filter_info() for _ in range(count)]


def scan_inventory_locations(path: str) -> list[tuple[int, int]]:
    """(run_accession, file offset) pairs sorted by accession."""
    out: list[tuple[int, int]] = []
    with open(path, "rb") as f:
        (count,) = struct.unpack("<Q", f.read(8))
        r = BinaryReader(f)
        for _ in range(count):
            loc = f.tell()
            info = r.filter_info()
            out.append((info.run_accession, loc))
    out.sort()
    return out


def read_filter_info_at(path: str, offset: int) -> FilterInfo:
    with open(path, "rb") as f:
        f.seek(offset)
        return BinaryReader(f).filter_info()
