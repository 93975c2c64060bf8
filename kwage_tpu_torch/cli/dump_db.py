"""dump_db: print database header, optional raw bit slices, and annotations.

Output-compatible with the reference tool (dump_db.cpp:23-326), including
its quirk of sending the bytes-per-slice / info-start lines to stdout even
when -o redirects everything else to a file.
"""

from __future__ import annotations

import getopt
import sys

from ..io.db_file import DBFileHeader, HEADER_SIZE, NO_COMPRESSION, RLE_COMPRESSION
from ..io.dbz_file import ZLIB_CHUNKED_COMPRESSION, open_database
from ._render import cli_errors, hash_func_label, render_annotation


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    inputs: list[str] = []
    output_filename = ""
    num_bit_slice = 0

    try:
        opts, _ = getopt.gnu_getopt(argv, "o:i:h?", ["bits=", "bits.all", "bits.none"])
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        return 1

    print_usage = not argv
    for flag, val in opts:
        if flag == "-o":
            output_filename = val
        elif flag == "-i":
            inputs.append(val)
        elif flag == "--bits":
            num_bit_slice = int(val)
        elif flag == "--bits.all":
            num_bit_slice = 0xFFFFFFFFFFFFFFFF
        elif flag == "--bits.none":
            num_bit_slice = 0
        elif flag in ("-h", "-?"):
            print_usage = True

    if print_usage:
        print(f"Usage: {sys.argv[0]} [-o <output>] [--bits <n>|--bits.all|--bits.none] -i <db file> ...", file=sys.stderr)
        return 0
    if not inputs:
        print("Please specify one or more filenames", file=sys.stderr)
        return 1

    out = open(output_filename, "w") if output_filename else sys.stdout
    try:
        for path in inputs:
            # Parse the header directly so it prints for ANY compression
            # value; the reference dump_db prints the full header and then
            # bails politely on compressed files (dump_db.cpp:130-160).
            with open(path, "rb") as f:
                h = DBFileHeader.unpack(f.read(HEADER_SIZE))
            print(f"Header information for {path}", file=out)
            print(f"\tmagic = {h.magic}", file=out)
            print(f"\tversion = {h.version}", file=out)
            print(f"\tcrc32 = {h.crc32:x}", file=out)
            print(f"\tkmer_len = {h.kmer_len}", file=out)
            print(f"\tnum_hash = {h.num_hash}", file=out)
            print(f"\tfilter_len = {h.filter_len}", file=out)
            print(f"\tlog_2_filter_len = {h.log_2_filter_len}", file=out)
            print(f"\tnum_filter = {h.num_filter}", file=out)
            print(f"\thash_func = {hash_func_label(h.hash_func)}", file=out)
            if h.compression == NO_COMPRESSION:
                print("\tcompression = None", file=out)
            elif h.compression == RLE_COMPRESSION:
                print("\tcompression = RLE", file=out)
            elif h.compression == ZLIB_CHUNKED_COMPRESSION:
                print("\tcompression = zlib-chunked", file=out)
            else:
                print("\tcompression = Invalid", file=out)
            if h.compression not in (NO_COMPRESSION, ZLIB_CHUNKED_COMPRESSION):
                print("Compressed database files are not currently supported!", file=sys.stderr)
                return 0
            reader = open_database(path)

            # These two lines go to stdout unconditionally in the reference.
            print(f"There are {h.slice_size} bytes per slice")
            print(f"Info start @ {h.info_start}")
            if h.info_start == 0:
                print("** Info start is 0 -- database is not complete! **", file=sys.stderr)
                return 0

            num_slice = min(num_bit_slice, h.filter_len)
            if num_slice > 0:
                print(f"Raw bits for the first {num_slice} bitslices", file=out)
                import numpy as np

                rows = reader.read_slice_rows(np.arange(num_slice))
                bits = np.unpackbits(rows, axis=1, bitorder="little")[:, : h.num_filter]
                for i in range(num_slice):
                    print(str(i) + "".join(f" {b}" for b in bits[i]), file=out)

            for i, info in enumerate(reader.read_all_filter_info()):
                print(f"Annotation information for Bloom filter {i}", file=out)
                for line in render_annotation(info, sorted_attribs=True):
                    print(line, file=out)
                print(file=out)
    finally:
        if output_filename:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
