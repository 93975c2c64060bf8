"""Low-level binary stream codec matching the reference conventions.

All integers are little-endian (x86/TPU-host native, matching the
reference's raw ``write((char*)&obj, sizeof(obj))`` on x86). Strings are
NUL-terminated with no length prefix (binary_io.cpp:13-53); maps are a
uint64 count followed by key/value pairs (binary_io.h:177-217); container
sizes are uint64 (size_t on the reference platforms).
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from ..core.dates import Date
from ..core.info import FilterInfo
from ..core.params import BloomParam


class BinaryReader:
    def __init__(self, f: BinaryIO):
        self.f = f

    def read(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise EOFError(f"expected {n} bytes, got {len(data)}")
        return data

    def u8(self) -> int:
        return self.read(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def string(self) -> str:
        out = bytearray()
        while True:
            c = self.f.read(1)
            if len(c) != 1:
                raise EOFError("EOF inside NUL-terminated string")
            if c == b"\x00":
                break
            out += c
        return out.decode("utf-8", errors="replace")

    def string_map(self) -> dict[str, str]:
        count = self.u64()
        return {self.string(): self.string() for _ in range(count)}

    def date(self) -> Date:
        day, month, year = struct.unpack("<III", self.read(12))
        return Date(day=day, month=month, year=year)

    def bloom_param(self) -> BloomParam:
        kmer_len, log2_len, num_hash, hash_func = struct.unpack("<IIIi", self.read(16))
        return BloomParam(
            kmer_len=kmer_len,
            log_2_filter_len=log2_len,
            num_hash=num_hash,
            hash_func=hash_func,
        )

    def filter_info(self) -> FilterInfo:
        """FilterInfo in X-macro member order (bloom.h:478-496)."""
        info = FilterInfo()
        info.run_accession = self.u64()
        info.experiment_accession = self.u64()
        info.experiment_title = self.string()
        info.experiment_design_description = self.string()
        info.experiment_library_name = self.string()
        info.experiment_library_strategy = self.string()
        info.experiment_library_source = self.string()
        info.experiment_library_selection = self.string()
        info.experiment_instrument_model = self.string()
        info.sample_accession = self.u64()
        info.sample_taxa = self.string()
        info.sample_attributes = self.string_map()
        info.study_accession = self.u64()
        info.study_title = self.string()
        info.study_abstract = self.string()
        info.number_of_spots = self.u64()
        info.number_of_bases = self.u64()
        info.date_received = self.date()
        return info


class BinaryWriter:
    def __init__(self, f: BinaryIO):
        self.f = f

    def write(self, data: bytes) -> None:
        self.f.write(data)

    def u8(self, v: int) -> None:
        self.f.write(bytes([v & 0xFF]))

    def u32(self, v: int) -> None:
        self.f.write(struct.pack("<I", v & 0xFFFFFFFF))

    def i32(self, v: int) -> None:
        self.f.write(struct.pack("<i", v))

    def u64(self, v: int) -> None:
        self.f.write(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))

    def f32(self, v: float) -> None:
        self.f.write(struct.pack("<f", v))

    def string(self, s: str) -> None:
        self.f.write(s.encode("utf-8") + b"\x00")

    def string_map(self, m: dict[str, str]) -> None:
        self.u64(len(m))
        for k, v in m.items():
            self.string(k)
            self.string(v)

    def date(self, d: Date) -> None:
        self.f.write(struct.pack("<III", d.day, d.month, d.year))

    def bloom_param(self, p: BloomParam) -> None:
        self.f.write(
            struct.pack("<IIIi", p.kmer_len, p.log_2_filter_len, p.num_hash, p.hash_func)
        )

    def filter_info(self, info: FilterInfo) -> None:
        # One encoded blob + one write (the per-field method chain costs
        # ~46 us/record, which at the reference's 4M-accession inventory
        # scale is minutes of pure call overhead). Field order is the
        # X-macro order (bloom.h:478-496), identical to the per-field
        # twin byte for byte.
        m = 0xFFFFFFFFFFFFFFFF
        parts = [
            struct.pack("<QQ", info.run_accession & m,
                        info.experiment_accession & m),
            info.experiment_title.encode("utf-8"), b"\x00",
            info.experiment_design_description.encode("utf-8"), b"\x00",
            info.experiment_library_name.encode("utf-8"), b"\x00",
            info.experiment_library_strategy.encode("utf-8"), b"\x00",
            info.experiment_library_source.encode("utf-8"), b"\x00",
            info.experiment_library_selection.encode("utf-8"), b"\x00",
            info.experiment_instrument_model.encode("utf-8"), b"\x00",
            struct.pack("<Q", info.sample_accession & m),
            info.sample_taxa.encode("utf-8"), b"\x00",
            struct.pack("<Q", len(info.sample_attributes)),
        ]
        for k, v in info.sample_attributes.items():
            parts += [k.encode("utf-8"), b"\x00", v.encode("utf-8"), b"\x00"]
        d = info.date_received
        parts += [
            struct.pack("<Q", info.study_accession & m),
            info.study_title.encode("utf-8"), b"\x00",
            info.study_abstract.encode("utf-8"), b"\x00",
            struct.pack("<QQIII", info.number_of_spots & m,
                        info.number_of_bases & m, d.day, d.month, d.year),
        ]
        self.f.write(b"".join(parts))
