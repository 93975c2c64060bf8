"""bff: "Bloom filter factory" -- build filters for named accessions
standalone with a full progress dump (the reference bff.cpp test rig).
"""

from __future__ import annotations

import getopt
import sys
import time

from ..core import FilterInfo, str_to_accession
from ..io.bloom_file import write_bloom_file
from ..pipeline.make_bloom import (
    BloomInvalid,
    BuildOptions,
    build_bloom_from_file,
    counting_filter_log2_len,
)
from ..io.sequence import iter_sequences
from ._render import cli_errors


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv

    opts = BuildOptions()
    out_dir = "."
    source_dir = ""
    try:
        flags, accessions = getopt.gnu_getopt(
            argv, "k:p:o:h?",
            ["min-kmer-count=", "len.min=", "len.max=", "source-dir=",
             "count-len.min=", "count-len.max="],
        )
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        return 1

    for flag, val in flags:
        if flag == "-k":
            opts.kmer_len = int(val)
        elif flag == "-p":
            opts.false_positive_probability = float(val)
        elif flag == "-o":
            out_dir = val
        elif flag == "--min-kmer-count":
            opts.min_kmer_count = int(val)
        elif flag == "--len.min":
            opts.min_log_2_filter_len = int(val)
        elif flag == "--len.max":
            opts.max_log_2_filter_len = int(val)
        elif flag == "--count-len.min":
            opts.min_log_2_count_len = int(val)
        elif flag == "--count-len.max":
            opts.max_log_2_count_len = int(val)
        elif flag == "--source-dir":
            source_dir = val
        elif flag in ("-h", "-?"):
            accessions = []

    if not accessions:
        print("Usage: bff [options] <accession file or path> ...", file=sys.stderr)
        print("\t[-k <kmer len>] [-p <fp prob>] [--min-kmer-count <n>]", file=sys.stderr)
        print("\t[--len.min/--len.max <log2 filter len>] [-o <output dir>]", file=sys.stderr)
        print("\t[--source-dir <dir with <accession>.fasta files>]", file=sys.stderr)
        return 0

    import os

    for acc in accessions:
        path = acc
        name = os.path.basename(acc).split(".")[0]
        if source_dir:
            from ..parallel.maestro import LocalFastaResolver

            resolved = LocalFastaResolver(source_dir).resolve(acc)
            if resolved is None:
                print(f"{acc}: no local sequence file found", file=sys.stderr)
                continue
            path, name = resolved, acc

        num_bp = sum(len(seq) for _, seq in iter_sequences(path))
        print(f"{name}: {num_bp} bp; counting filter log2 len = "
              f"{counting_filter_log2_len(num_bp, opts)}", file=sys.stderr)

        t0 = time.time()
        try:
            info = FilterInfo()
            try:
                info.run_accession = str_to_accession(name)
            except ValueError:
                pass
            rec = build_bloom_from_file(path, opts, info)
        except BloomInvalid as e:
            print(f"{name}: STATUS_BLOOM_INVALID ({e})", file=sys.stderr)
            continue
        dt = time.time() - t0
        out_path = os.path.join(out_dir, name + ".bloom")
        write_bloom_file(out_path, rec)
        occupancy = rec.count() / rec.param.filter_len
        print(
            f"{name}: L={rec.param.log_2_filter_len} h={rec.param.num_hash} "
            f"crc32={rec.crc32:x} occupancy={occupancy:.4f} "
            f"({num_bp / max(dt, 1e-9) / 1e6:.2f} Mbp/s) -> {out_path}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
