"""dump_bloom: print a .bloom file's header, annotation, and raw bits.

Output-compatible with the reference tool (dump_bloom.cpp:20-138).
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.bloom_file import read_bloom_file
from ._render import cli_errors, hash_func_label, render_annotation


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(f"Usage: {sys.argv[0]} <KWAGE Bloom filter file>", file=sys.stderr)
        return 0

    rec = read_bloom_file(argv[0])
    p = rec.param
    print(f"Header information for {argv[0]}")
    print(f"\tcrc32 = {rec.crc32:x}")
    print(f"\tlength = {p.filter_len}")
    print(f"\tlog_2 length = {p.log_2_filter_len}")
    print(f"\tnum_hash = {p.num_hash}")
    print(f"\tkmer_len = {p.kmer_len}")
    print(f"\thash_func = {hash_func_label(p.hash_func)}")

    print("Annotation information for Bloom filter ")
    for line in render_annotation(rec.info, sorted_attribs=False):
        print(line)

    print("Raw bits:")
    bits = np.unpackbits(rec.bits, bitorder="little")
    out = sys.stdout
    for i in range(p.filter_len):
        out.write(f"{i}\t{bits[i]}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
