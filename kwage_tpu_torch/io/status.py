"""Maestro status/checkpoint file (file_io.cpp:201-282).

Layout: [u64 database_index][u64 num_sra][num_sra x u8 status].
Writes are atomic via temp-file + rename.
"""

from __future__ import annotations

import os
import struct

import numpy as np


def write_status_file(path: str, status: np.ndarray, database_index: int) -> None:
    tmp = path + ".temp"
    status = np.asarray(status, dtype=np.uint8)
    with open(tmp, "wb") as f:
        f.write(struct.pack("<QQ", database_index, status.shape[0]))
        f.write(status.tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def read_status_file(path: str, expected_num_sra: int | None = None) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        database_index, num_sra = struct.unpack("<QQ", f.read(16))
        if expected_num_sra is not None and num_sra != expected_num_sra:
            raise ValueError(
                f"status file has {num_sra} records, expected {expected_num_sra}"
            )
        status = np.frombuffer(f.read(num_sra), dtype=np.uint8).copy()
        if status.shape[0] != num_sra:
            raise ValueError("truncated status file")
    return status, database_index
