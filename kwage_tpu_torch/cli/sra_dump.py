"""sra_dump: standalone read-stream profiler for one accession.

The reference tool (sra_dump.cpp:10-203) opens an accession via the NGS
API and times the raw read stream (optionally printing the reads). This
engine streams local FASTA/FASTQ(.gz) files -- the same sources the
pipeline ingests -- and reports the identical throughput counters
(reads, bases, Mbp/sec).
"""

from __future__ import annotations

import getopt
import os
import sys
import time

from ..io.sequence import iter_sequences
from ._render import cli_errors


def _usage(out=sys.stderr) -> None:
    print("Usage: sra_dump [options] <FASTA/FASTQ sequence file>", file=out)
    print("\t[--print (write every read to stdout)]", file=out)
    print("\t[--max-read <stop after N reads>]", file=out)


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "h?", ["print", "max-read="])
    except getopt.GetoptError as e:
        print(f"Unknown option: {e}", file=sys.stderr)
        return 1
    do_print = False
    max_read = None
    for flag, value in opts:
        if flag == "--print":
            do_print = True
        elif flag == "--max-read":
            max_read = int(value)
        else:
            _usage()
            return 0
    if len(args) != 1:
        _usage()
        return 0

    src = args[0]
    downloaded = False
    if not os.path.exists(src):
        # Treat a non-local argument as an SRA accession (gated on the
        # SRA toolkit, like the reference's NGS openReadCollection).
        from ..sriracha.sra_source import resolve_accession

        src = resolve_accession(args[0])
        downloaded = True

    t0 = time.time()
    num_read = 0
    num_bp = 0
    try:
        for defline, seq in iter_sequences(src):
            num_read += 1
            num_bp += len(seq)
            if do_print:
                print(f">{defline}")
                print(seq)
            if max_read is not None and num_read >= max_read:
                break
    finally:
        if downloaded:
            import shutil

            shutil.rmtree(os.path.dirname(src), ignore_errors=True)
    dt = max(time.time() - t0, 1e-9)

    print(f"Found {num_read} reads; {num_bp} bases", file=sys.stderr)
    print(
        f"Streamed in {dt:.2f} sec ({num_bp / dt / 1.0e6:.2f} Mbp/sec; "
        f"{num_read / dt:.1f} reads/sec)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
