"""bloom_diff: bit-level comparison of two .bloom files (bloom_diff.cpp:27-255)."""

from __future__ import annotations

import sys
import zlib

import numpy as np

from ..core.hash import hash_name
from ..io.binary import BinaryReader
from ..io.bloom_file import BLOOM_MAGIC_COMPLETE
from ._render import cli_errors


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(f"Usage: {sys.argv[0]} <Bloom filter file 1> <Bloom filter file 2>", file=sys.stderr)
        return 0

    handles = []
    params = []
    crcs = []
    for i, path in enumerate(argv, 1):
        f = open(path, "rb")
        handles.append(f)
        r = BinaryReader(f)
        if r.u8() != BLOOM_MAGIC_COMPLETE:
            print(f"Bloom filter {i} ({path}) is not complete!", file=sys.stderr)
            return 1
        params.append(r.bloom_param())
        crcs.append(r.u32())
        r.filter_info()

    p1, p2 = params
    if p1 != p2:
        print("Inconsistent Bloom filter parameters", file=sys.stderr)
        print(f"kmer_len = {p1.kmer_len} for 1;  {p2.kmer_len} for 2", file=sys.stderr)
        print(f"log_2_filter_len = {p1.log_2_filter_len} for 1; expected {p2.log_2_filter_len} for 2", file=sys.stderr)
        print(f"num_hash = {p1.num_hash} for 1; expected {p2.num_hash} for 2", file=sys.stderr)
        print(f"hash_func = {hash_name(p1.hash_func)} for 1; expected {hash_name(p2.hash_func)} for 2", file=sys.stderr)
        return 1

    if crcs[0] == crcs[1]:
        print(f"The crc32 values are the same for both Bloom filters ({crcs[0]:x})", file=sys.stderr)
    else:
        print("The Bloom filters have different crc32 values", file=sys.stderr)
        print(f"\tBloom filter 1 ({argv[0]}) crc32 = {crcs[0]:x}", file=sys.stderr)
        print(f"\tBloom filter 2 ({argv[1]}) crc32 = {crcs[1]:x}", file=sys.stderr)

    filter_len = p1.filter_len
    computed = [zlib.crc32(b""), zlib.crc32(b"")]
    diff_bits = 0
    chunk = 1 << 20
    remaining = filter_len // 8
    while remaining:
        n = min(chunk, remaining)
        bufs = []
        for j, f in enumerate(handles):
            data = f.read(n)
            computed[j] = zlib.crc32(data, computed[j])
            bufs.append(np.frombuffer(data, dtype=np.uint8))
        diff_bits += int(np.unpackbits(bufs[0] ^ bufs[1]).sum())
        remaining -= n

    pct = (100.0 * diff_bits) / filter_len
    print(
        f"The Bloom filters differ by {diff_bits} bits of out {filter_len} bits: {pct:g}%",
        file=sys.stderr,
    )
    for j in range(2):
        if (computed[j] & 0xFFFFFFFF) != crcs[j]:
            print(f"The crc32 disagreement for Bloom filter {j + 1}: {argv[j]}", file=sys.stderr)
            print(f"\tComputed crc32: {computed[j] & 0xFFFFFFFF:x}", file=sys.stderr)
            print(f"\tFile crc32: {crcs[j]:x}", file=sys.stderr)
    for f in handles:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
