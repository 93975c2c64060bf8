"""db_debug: synthetic-filter integration harness for the transpose.

The reference's rig (db_debug.cpp:17-103) builds 257 random Bloom filters
(one more than a slice byte boundary, to exercise the padding path), runs
the full build_db transpose on them, and verifies every output bit. Same
here, end to end through the on-disk formats: random filters -> .bloom
files -> .db -> read back -> bit-exact check of every slice against every
source filter, plus crc32 and annotation round-trips.
"""

from __future__ import annotations

import getopt
import os
import sys
import tempfile
import time
import zlib

import numpy as np

from ..core.accession import str_to_accession
from ..core.info import FilterInfo
from ..core.params import BloomParam
from ..io.bloom_file import BloomFilterRecord, write_bloom_file
from ..io.db_file import DBFileReader
from ..pipeline.build_db import build_db_from_bloom_files
from ._render import cli_errors


def _usage(out=sys.stderr) -> None:
    print("Usage: db_debug [options]", file=out)
    print("\t[-n <number of synthetic filters>] (default is 257)", file=out)
    print("\t[--len <log2 filter len>] (default is 18)", file=out)
    print("\t[--seed <RNG seed>] (default is 0)", file=out)


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "n:h?", ["len=", "seed="])
    except getopt.GetoptError as e:
        print(f"Unknown option: {e}", file=sys.stderr)
        return 1
    num_filter = 257
    log2_len = 18
    seed = 0
    for flag, value in opts:
        if flag == "-n":
            num_filter = int(value)
        elif flag == "--len":
            log2_len = int(value)
        elif flag == "--seed":
            seed = int(value)
        else:
            _usage()
            return 0
    if args:
        _usage()
        return 0

    param = BloomParam(kmer_len=31, log_2_filter_len=log2_len, num_hash=3, hash_func=0)
    nbytes = param.filter_len // 8
    rng = np.random.default_rng(seed)
    t0 = time.time()

    with tempfile.TemporaryDirectory(prefix="db_debug.") as work:
        filters = rng.integers(0, 256, size=(num_filter, nbytes), dtype=np.uint8)
        paths = []
        for j in range(num_filter):
            info = FilterInfo(run_accession=str_to_accession(f"SRR{j + 1}"))
            rec = BloomFilterRecord(
                param=param,
                crc32=zlib.crc32(filters[j].tobytes()) & 0xFFFFFFFF,
                info=info,
                bits=filters[j],
            )
            path = os.path.join(work, f"f{j}.bloom")
            write_bloom_file(path, rec)
            paths.append(path)
        print(f"Created {num_filter} random filters (L = 2^{log2_len})", file=sys.stderr)

        db_path = os.path.join(work, "sra.0.db")
        build_db_from_bloom_files(db_path, param, paths)
        print(f"Transposed into {db_path}", file=sys.stderr)

        reader = DBFileReader(db_path)
        hdr = reader.header
        ok = True
        if hdr.num_filter != num_filter or hdr.log_2_filter_len != log2_len:
            print("ERROR: header mismatch")
            ok = False
        if not reader.verify_crc32():
            print("ERROR: slice data crc32 mismatch")
            ok = False

        # Every bit: slice row s, filter j <=> filter j, bit s.
        slices = reader.read_slices()  # [L, slice_size] uint8
        slice_bits = np.unpackbits(slices, axis=1, bitorder="little")[:, :num_filter]
        filter_bits = np.unpackbits(filters, axis=1, bitorder="little")
        mismatches = int((slice_bits != filter_bits.T).sum())
        if mismatches:
            print(f"ERROR: {mismatches} transposed bits differ")
            ok = False

        infos = reader.read_all_filter_info()
        for j, info in enumerate(infos):
            if info.run_accession != str_to_accession(f"SRR{j + 1}"):
                print(f"ERROR: annotation {j} round-trip failed")
                ok = False
                break

    dt = time.time() - t0
    total_bits = num_filter * param.filter_len
    if not ok:
        return 1
    print(f"PASS: {total_bits} bits verified in {dt:.2f} sec")
    return 0


if __name__ == "__main__":
    sys.exit(main())
