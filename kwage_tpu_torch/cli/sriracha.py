"""sriracha for the PyTorch + CUDA port (script ``kwage-sriracha-torch``).

The flags and output of kwage_tpu.cli.sriracha (and of the reference
SriRachA tool, SriRachA/main.cpp, options.cpp), with ``--device`` routed
to the port's search_reads_device at all three of its sites: a streamed
remote accession, a toolkit-materialised file and local files. The reads
are split over every visible card (``KWAGE_TORCH_DEVICE``, default
``cuda``; ``cuda:i`` names one card), as the JAX package's CLI shards over
every device; a missing card raises. Without ``--device`` the host engine runs, as in
the JAX package's CLI. This module never imports jax.
"""

from __future__ import annotations

import getopt
import os
import sys
import time

from .. import SRIRACHA_VERSION
from ..sriracha.device import search_reads_device
from ..sriracha.engine import (
    CHATTY,
    DEFAULT_KMER_LENGTH,
    DEFAULT_KMER_MATCH_THRESHOLD,
    DEFAULT_MAX_MATCH,
    DEFAULT_MIN_READ_COMPLEXITY,
    DEFAULT_MIN_READ_LENGTH,
    DEFAULT_MIN_VALID_KMER,
    MAX_KMER_LEN,
    MIN_KMER_LEN,
    NORMAL,
    SrirachaOptions,
    StreamStats,
    format_results,
    load_subject_kmers,
    search_accession,
)
from ..utils.runtime import resolve_device
from ._render import cli_errors


def usage() -> None:
    e = sys.stderr
    print(f"Usage for SriRachA (v. {SRIRACHA_VERSION}):", file=e)
    print("\t-i <input sequence files> (can be repeated)", file=e)
    print("\t[-o <output filename>] (default is stdout)", file=e)
    print(f"\t[--read.len.min <minimum read length>] (default is {DEFAULT_MIN_READ_LENGTH})", file=e)
    print(f"\t[--max-results <maximum number of results to show per accession/query>] (default is {DEFAULT_MAX_MATCH})", file=e)
    print("\t[-a <list of SRA accessions in a text file>]", file=e)
    print("\t[-v (increase the verbosity: silent, tacitern, normal, chatty. Default is silent)]", file=e)
    print("\t[--retry <maximum number of download atttemps>] (default is 0)", file=e)
    print("\t[--slice <slice number [0, N)]>] (not compatible with MPI)", file=e)
    print("\t[--of <number of slices, N>] (not compatible with MPI)", file=e)
    print("\t[--device (run the batched GPU search kernels)]", file=e)
    print("\t[--threads <n> (host-path search threads over the read range; "
          "the reference's OpenMP local-file split)]", file=e)
    print("\t[--merge-slices <slice TSV> (repeatable; merge independent "
          "--slice/--of outputs into the single-job TSV: re-sort, re-cull "
          "to --max-results, all-slices-agree // terminator. Give the "
          "same -i/-a/accession arguments as the sliced runs)]", file=e)
    print("\tSearch strategies", file=e)
    print("\t\t[--search-by-kmer] (default)", file=e)
    print(f"\t\t\t[-k <k-mer length>] (default is {DEFAULT_KMER_LENGTH})", file=e)
    print(f"\t\t\t[-t <match threshold>] (default is {DEFAULT_KMER_MATCH_THRESHOLD})", file=e)
    print(f"\t\t\t[-n <min number valid kmer>] (default is {DEFAULT_MIN_VALID_KMER})", file=e)
    print(f"\t\t\t[--read.complexity.min <min read complexity>] (default is {DEFAULT_MIN_READ_COMPLEXITY})", file=e)
    print("\t<SRA accession or file or dir> ...", file=e)


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    start = time.time()
    opt = SrirachaOptions()
    merge_slices: list[str] = []

    try:
        flags, args = getopt.gnu_getopt(
            argv,
            "k:t:n:o:i:a:vh?",
            ["search-by-align", "search-by-kmer", "search-by-bloom",
             "read.len.min=", "read.complexity.min=", "max-results=",
             "vv", "vvv", "vvvv", "retry=", "slice=", "of=", "device",
             "threads=", "merge-slices="],
        )
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        usage()
        return 1

    if not argv:
        usage()
        return 0

    for flag, val in flags:
        if flag == "-i":
            opt.input_sequence_files.append(val)
        elif flag == "-o":
            opt.output_filename = val
        elif flag == "-a":
            opt.sra_accession_filename = val
        elif flag == "-k":
            opt.kmer_len = abs(int(val))
        elif flag == "-t":
            opt.kmer_match_threshold = float(val)
        elif flag == "-n":
            opt.min_valid_kmer = abs(int(val))
        elif flag == "-v":
            opt.verbose += 1
        elif flag == "--vv":
            opt.verbose += 2
        elif flag == "--vvv":
            opt.verbose += 3
        elif flag == "--vvvv":
            opt.verbose += 4
        elif flag == "--read.len.min":
            opt.min_read_length = abs(int(val))
        elif flag == "--read.complexity.min":
            opt.min_read_complexity = float(val)
        elif flag == "--max-results":
            opt.max_num_match = int(abs(float(val)))
        elif flag == "--retry":
            opt.max_retry = abs(int(val))
        elif flag == "--slice":
            # No abs(): a negative slice must fail the range check, not
            # fold into a different shard.
            opt.slice_index = int(val)
        elif flag == "--of":
            opt.num_slice = max(1, int(val))
        elif flag == "--threads":
            opt.num_threads = max(1, int(val))
        elif flag == "--merge-slices":
            merge_slices.append(val)
        elif flag == "--device":
            opt.use_device = True
        elif flag in ("-h", "-?"):
            usage()
            return 0
        elif flag == "--search-by-align":
            print("Currently, SriRachA only supports search by kmer", file=sys.stderr)
            return 0
        elif flag == "--search-by-bloom":
            print("Currently, SriRachA only supports search by kmer", file=sys.stderr)
            return 0

    opt.sra_accession = list(args)

    # Options-stage rejections exit 0 like the reference: quit + stderr,
    # EXIT_SUCCESS (SriRachA/main.cpp:99-104); callers key off output.
    if opt.min_valid_kmer == 0:
        print("Please specify: 0 < minimum number of valid kmers", file=sys.stderr)
        return 0
    if opt.max_num_match == 0:
        print("Please specify: 0 < max number of matches to report", file=sys.stderr)
        return 0
    if not MIN_KMER_LEN <= opt.kmer_len <= MAX_KMER_LEN:
        print(f"Please specify: {MIN_KMER_LEN} <= kmer length <= {MAX_KMER_LEN}", file=sys.stderr)
        return 0
    if not 0.0 < opt.kmer_match_threshold <= 1.0:
        print("Please specify: 0.0 < kmer match threshold <= 1.0", file=sys.stderr)
        return 0
    if not 0 <= opt.slice_index < opt.num_slice:
        print("Please specify: slice index < number of slices", file=sys.stderr)
        return 0
    if not opt.input_sequence_files:
        print("Please specify at least one input sequence file (-i)", file=sys.stderr)
        return 0

    if merge_slices:
        # Cross-slice merge mode (engine extension mechanics, reference
        # semantics): reproduce rank 0's gather + re-sort + re-cull +
        # all-slices-agree terminator (SriRachA/main.cpp:462-578) from
        # independently written --slice/--of TSVs. -i and the accession
        # arguments fix the output ordering exactly as they did for the
        # sliced runs.
        from ..io.sequence import iter_sequences
        from ..sriracha.engine import merge_slice_tsvs

        deflines = []
        for path in opt.input_sequence_files:
            deflines += [d for d, _ in iter_sequences(path)]
        accessions = list(opt.sra_accession)
        if opt.sra_accession_filename:
            with open(opt.sra_accession_filename) as f:
                accessions += f.read().split()
        if not accessions:
            accessions = sys.stdin.read().split()
        try:
            texts = []
            for path in merge_slices:
                with open(path) as f:
                    texts.append(f.read())
            merged = merge_slice_tsvs(
                texts, deflines, accessions, opt.max_num_match)
        except (OSError, ValueError) as e:
            print(f"slice merge failed: {e}", file=sys.stderr)
            return 1
        if opt.output_filename:
            try:
                with open(opt.output_filename, "w") as f:
                    f.write(merged)
            except OSError:
                print(f"Unable to open {opt.output_filename} for writing",
                      file=sys.stderr)
                return 0
        else:
            sys.stdout.write(merged)
        return 0

    if opt.output_filename:
        try:
            out = open(opt.output_filename, "w")
        except OSError:
            # quit + EXIT_SUCCESS like the reference (main.cpp:86-104) --
            # note kwage differs (EXIT_FAILURE there); each is mirrored.
            print(f"Unable to open {opt.output_filename} for writing",
                  file=sys.stderr)
            return 0
    else:
        out = sys.stdout
    try:
        # A missing card raises here, before any output.
        if opt.use_device:
            resolve_device()
        subject_kmers = load_subject_kmers(
            opt.input_sequence_files, opt.kmer_len, opt.verbose
        )

        accessions = list(opt.sra_accession)
        if opt.sra_accession_filename:
            with open(opt.sra_accession_filename) as f:
                accessions += f.read().split()
        if not accessions:
            accessions = sys.stdin.read().split()

        failed = False
        for acc in accessions:
            if opt.verbose >= NORMAL:
                print(f"Searching {acc} ... ", end="", file=sys.stderr)
            t0 = time.time()
            stats = StreamStats()
            try:
                # Non-local accessions resolve through the SRA toolkit;
                # network-classed failures retry like the reference's
                # per-rank loop (SriRachA/main.cpp:400-445).
                from ..sriracha.sra_source import (
                    DownloadError,
                    is_local_source,
                    is_retryable,
                    resolve_accession,
                    stream_accession,
                )

                if opt.num_slice > 1:
                    from ..sriracha import vdb as _vdb

                    # Mirror stream_accession's own gate exactly: with
                    # KWAGE_NO_VDB=1 the pipe (which cannot seek) would
                    # be chosen and sliced streaming raises -- take the
                    # materialize fallback instead.
                    can_stream_sliced = (
                        os.environ.get("KWAGE_NO_VDB") != "1"
                        and _vdb.available()
                    )
                else:
                    can_stream_sliced = True
                if not is_local_source(acc) and can_stream_sliced:
                    # Remote accession: stream the reads straight into the
                    # search -- zero scratch, the reference's VDB streaming
                    # shape (sra_stream.cpp:90-211). Network-classed
                    # failures restart the whole accession like the
                    # reference's per-rank retry loop
                    # (SriRachA/main.cpp:401-445). Sliced runs
                    # (--slice/--of) stream only when libncbi-vdb is
                    # present (VCursorIdRange gives the row range up
                    # front, sra_stream.cpp:336-356); the toolkit pipe
                    # cannot seek, so sliced runs without the library
                    # materialize below.
                    from ..sriracha.engine import StreamStats as _SS, search_reads

                    attempt = 0
                    while True:
                        stats_try = _SS()
                        try:
                            # Per-fragment records with the reference's
                            # (spot, 1-based subindex) numbering -- TSV
                            # rows render as idx.sub (main.cpp:560-578).
                            reads = (
                                (seq, i, sub)
                                for i, sub, seq in stream_accession(
                                    acc, opt.slice_index, opt.num_slice
                                )
                            )
                            if opt.use_device:
                                results = search_reads_device(
                                    reads, subject_kmers, opt, stats_try,
                                )
                            else:
                                results = search_reads(
                                    reads, subject_kmers, opt, stats_try
                                )
                            stats.num_reads = stats_try.num_reads
                            stats.num_bases = stats_try.num_bases
                            break
                        except DownloadError as e:
                            attempt += 1
                            if not (is_retryable(e.status) and attempt <= opt.max_retry):
                                raise
                            print(
                                f"retrying {acc} after network failure "
                                f"(attempt {attempt})",
                                file=sys.stderr,
                            )
                else:
                    src = acc
                    downloaded = False
                    if not is_local_source(acc):
                        attempt = 0
                        while True:
                            try:
                                src = resolve_accession(acc)
                                downloaded = True
                                break
                            except DownloadError as e:
                                attempt += 1
                                if not (is_retryable(e.status) and attempt <= opt.max_retry):
                                    raise
                                print(
                                    f"retrying {acc} after network failure "
                                    f"(attempt {attempt})",
                                    file=sys.stderr,
                                )
                    try:
                        if downloaded:
                            # Toolkit-materialized --split-spot file: use
                            # the (spot, subindex) synthesis + spot-based
                            # slicing so TSV idx.sub rows and --slice
                            # sharding match the streamed VDB/pipe path
                            # exactly (sra_stream.cpp:221-413).
                            from ..sriracha.engine import (
                                iter_toolkit_fragments_range,
                                search_reads,
                            )

                            frag_iter = iter_toolkit_fragments_range(
                                src, opt.slice_index, opt.num_slice
                            )
                            if opt.use_device:
                                results = search_reads_device(
                                    frag_iter, subject_kmers, opt, stats,
                                )
                            else:
                                results = search_reads(
                                    frag_iter, subject_kmers, opt, stats
                                )
                        else:
                            results = search_accession(
                                src, subject_kmers, opt, stats
                            )
                    finally:
                        if downloaded:
                            # The reference streams reads without persisting
                            # them; drop the materialized FASTQ likewise.
                            import shutil

                            shutil.rmtree(os.path.dirname(src), ignore_errors=True)
            except OSError as e:
                print(f"Unable to download SRA accession: {acc} ({e})", file=sys.stderr)
                out.write(f"{acc}\tNA\t0\tDownload failed\n")
                failed = True
                continue
            out.write(format_results(acc, subject_kmers, results))
            dt = time.time() - t0
            if opt.verbose >= NORMAL:
                print(
                    f"complete in {dt:g} sec; {stats.num_reads} reads and "
                    f"{stats.num_bases} bases; "
                    f"{stats.num_bases / (max(1.0, dt) * 1.0e6):g} Mbp/sec",
                    file=sys.stderr,
                )

        if not failed:
            out.write("//\n")
        print(f"Completed SRA streaming in {time.time() - start:g} sec", file=sys.stderr)
    finally:
        if opt.output_filename:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
