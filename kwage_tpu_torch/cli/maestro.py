"""maestro for the PyTorch + CUDA port: the flags of kwage_tpu.cli.maestro
(``usage`` and ``LONG_OPTS`` are its own), building the port's Maestro.

``--device-build`` (exact-count ingest) and ``--device-transpose`` (the
``.db`` pack) run on ``KWAGE_TORCH_DEVICE`` (default ``cuda``); without
a card they raise, as ``resolve_device`` does, before a ``--worker`` pulls
its first task. ``--coordinator`` serves the work queue of
``parallel.remote`` (with ``--workers`` local pull workers) and
``--worker`` pulls from it, as in the JAX package; the coordinator prints
the address it bound (``LISTENING``), so that port 0 may be asked for.
"""

from __future__ import annotations

import getopt
import os
import sys

from .. import MAESTRO_VERSION
from ..core.hash import parse_hash_function_name, UNKNOWN_HASH, hash_name
from ..core.params import (
    DEFAULT_FALSE_POSITIVE_PROBABILITY,
    DEFAULT_KMER_LENGTH,
    DEFAULT_MAX_LOG_2_FILTER_LEN,
    DEFAULT_MIN_LOG_2_FILTER_LEN,
    DEFAULT_SRA_MIN_KMER_COUNT,
    MAX_SRA_MIN_KMER_COUNT,
)
from ..parallel.maestro import (
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
    PrefetchResolver,
    StreamingResolver,
)
from ..utils.runtime import resolve_device
from ._render import cli_errors

LONG_OPTS = [
    "min-kmer-count=", "hash=", "scratch=", "s3=", "meta=", "len.min=",
    "len.max=", "status=", "retry=", "halt-after=", "save.bloom", "save.db",
    "save.sra", "s3.no-write", "max-sra-download=", "stream", "retry.bloom",
    "delay=", "scratch.bloom=", "scratch.database=", "skip=",
    # engine-specific extensions
    "source-dir=", "prefetch", "workers=", "count-len.min=", "count-len.max=",
    "device-build", "compress", "device-transpose", "lazy-inventory",
    "device-batch=", "coordinator=", "worker=", "task-timeout=",
    "slice=", "of=",
]
# ``--coordinator``'s line on stderr, before the address it bound
# (``--coordinator 127.0.0.1:0`` binds a free port).
LISTENING = "coordinator listening on "


def usage() -> None:
    e = sys.stderr
    print(f"Usage for maestro (v. {MAESTRO_VERSION}):", file=e)
    print("\t--meta <binary SRA inventory file>", file=e)
    print("\t--scratch <scratch directory>", file=e)
    print("\t[--scratch.bloom <scratch directory for staging Bloom filter>]", file=e)
    print("\t[--scratch.database <scratch directory for staging database files>]", file=e)
    print("\t[--s3 <s3 bucket for database upload>]", file=e)
    print("\t[--s3.no-write (do *not* write database files to s3)]", file=e)
    print("\t[--stream (stream SRA data -- do not use prefetch to download!)]", file=e)
    print("\t[--max-sra-download <max allowed SRA file size in GB>] (default is 30)", file=e)
    print("\t[--status <binary SRA status file for restart>] (default is ./__sra_db_status.bin)", file=e)
    print("\t[--retry <number of download attempts>] (default is 3)", file=e)
    print("\t[--retry.bloom (retry all failed Bloom filters)]", file=e)
    print("\t[--delay <minimum number of seconds between download/streaming requests>]", file=e)
    print("\t[--halt-after <halt after this many SRA downloads> (default is not to stop)]", file=e)
    print(f"\t[-k <kmer length>] (default is {DEFAULT_KMER_LENGTH})", file=e)
    print(f"\t[-p <false positive probability (per k-mer, per-filter)>] (default is {DEFAULT_FALSE_POSITIVE_PROBABILITY})", file=e)
    print(f"\t[--min-kmer-count <minimum allowed k-mer count>] (default is {DEFAULT_SRA_MIN_KMER_COUNT})", file=e)
    print("\t[--hash <hash function name>] (default is murmur32)", file=e)
    print(f"\t[--len.min <log2 Bloom filter len>] (default is {DEFAULT_MIN_LOG_2_FILTER_LEN})", file=e)
    print(f"\t[--len.max <log2 Bloom filter len>] (default is {DEFAULT_MAX_LOG_2_FILTER_LEN})", file=e)
    print("\t[-v (turn on verbose output)]", file=e)
    print("\t[--save.bloom (don't remove Bloom filters after database construction)]", file=e)
    print("\t[--save.db (don't remove database file after S3 upload)]", file=e)
    print("\t[--save.sra (don't remove SRA files after Bloom filter construction)]", file=e)
    print("\t[--skip <SRA run accession> (skip over the specified accession; may be repeated)]", file=e)
    print("\t[--source-dir <directory of local <accession>.fasta files>] (engine extension)", file=e)
    print("\t[--prefetch (resolve accessions with the SRA toolkit)] (engine extension)", file=e)
    print("\t[--workers <N>] (engine extension, default 4)", file=e)
    print("\t[--device-build (exact-count thresholding on the CUDA device KWAGE_TORCH_DEVICE names, default cuda; one card; "
          "NOT counting-Bloom-aliased: with min.kmer.count > 1, bits can "
          "differ from reference-built filters whenever the reference's "
          "counting filter aliases -- see README 'Device-build parity "
          "envelope')] (engine extension)", file=e)
    print("\t[--compress (write zlib-chunked .dbz database files)] (engine extension)", file=e)
    print("\t[--device-transpose (bit-slice transpose on the same CUDA device)] (engine extension)", file=e)
    print("\t[--lazy-inventory (index the inventory; load records on demand)] (engine extension)", file=e)
    print("\t[--device-batch <N> (accessions fused per device dispatch, default 16)] (engine extension)", file=e)
    print("\t[--coordinator <host:port> (serve the work queue to remote workers over DCN; UNAUTHENTICATED unless KWAGE_QUEUE_SECRET is set on coordinator + workers -- bind loopback or a trusted network only)] (engine extension)", file=e)
    print("\t[--worker <host:port> (pull tasks from a remote coordinator)] (engine extension)", file=e)
    print("\t[--task-timeout <sec> (coordinator re-queues overdue tasks)] (engine extension)", file=e)
    print("\t[--slice <slice number [0, N)> --of <number of slices, N> (static multi-host split: this scheduler owns one contiguous inventory shard; give each shard its own --status and scratch; sra.<index>.db numbering interleaves without collision)] (engine extension)", file=e)


# flag -> (MaestroOptions field, parser)
_FIELDS = {
    "--meta": ("metadata_file", str),
    "--scratch.bloom": ("scratch_bloom_dir", str),
    "--scratch.database": ("scratch_database_dir", str),
    "--s3": ("s3_bucket", str),
    "--status": ("status_file", str),
    "--retry": ("num_download_attempt", lambda v: abs(int(v))),
    "--delay": ("download_delay", float),
    "--halt-after": ("limit_num_download", lambda v: abs(int(v))),
    "--min-kmer-count": ("min_kmer_count", lambda v: abs(int(v))),
    "--hash": ("hash_func", parse_hash_function_name),
    "--len.min": ("min_log_2_filter_len", lambda v: abs(int(v))),
    "--len.max": ("max_log_2_filter_len", lambda v: abs(int(v))),
    "--max-sra-download": ("max_sra_file_size_GB", lambda v: abs(int(v))),
    "-k": ("kmer_len", lambda v: abs(int(v))),
    "-p": ("false_positive_probability", float),
    "--workers": ("num_workers", lambda v: max(1, int(v))),
    "--device-batch": ("device_batch", lambda v: max(1, int(v))),
    # No abs(): a negative slice must hit the range check below.
    "--slice": ("slice_index", int),
    "--of": ("num_slice", lambda v: max(1, int(v))),
    "--count-len.min": ("min_log_2_count_len", lambda v: abs(int(v))),
    "--count-len.max": ("max_log_2_count_len", lambda v: abs(int(v))),
}
_SWITCHES = {
    "--s3.no-write": "s3_no_write", "--retry.bloom": "retry_bloom",
    "--stream": "stream_sra", "--save.bloom": "save_bloom", "--save.db": "save_db",
    "--save.sra": "save_sra", "-v": "verbose", "--device-build": "device_build",
    "--compress": "compress_db", "--device-transpose": "device_transpose",
    "--lazy-inventory": "lazy_inventory",
}


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        usage()
        return 0
    try:
        flags, _ = getopt.gnu_getopt(argv, "k:p:vh?", LONG_OPTS)
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        usage()
        return 1

    opt = MaestroOptions()
    scratch = source_dir = coordinator = worker_of = ""
    task_timeout = None
    use_prefetch = False
    for flag, val in flags:
        if flag in _FIELDS:
            name, parse = _FIELDS[flag]
            setattr(opt, name, parse(val))
        elif flag in _SWITCHES:
            setattr(opt, _SWITCHES[flag], True)
        elif flag == "--scratch":
            scratch = val
        elif flag == "--skip":
            opt.skip_sra.append(val)
        elif flag == "--source-dir":
            source_dir = val
        elif flag == "--prefetch":
            use_prefetch = True
        elif flag == "--coordinator":
            coordinator = val
        elif flag == "--worker":
            worker_of = val
        elif flag == "--task-timeout":
            task_timeout = float(val)
        elif flag in ("-h", "-?"):
            usage()
            return 0

    # Options-stage rejections exit 0 like the reference (maestro.cpp:51-55).
    if not opt.metadata_file:
        print("Please specify a binary inventory file (--meta)", file=sys.stderr)
        return 0
    if scratch:
        opt.scratch_bloom_dir = opt.scratch_bloom_dir or os.path.join(scratch, "bloom")
        opt.scratch_database_dir = opt.scratch_database_dir or os.path.join(scratch, "database")
    if not opt.scratch_bloom_dir or not opt.scratch_database_dir:
        print("Please specify scratch directories (--scratch)", file=sys.stderr)
        return 0
    if opt.hash_func == UNKNOWN_HASH:
        print("Unknown hash function name", file=sys.stderr)
        return 0
    if not 1 <= opt.min_kmer_count <= MAX_SRA_MIN_KMER_COUNT:
        print(f"Please specify: 1 <= min k-mer count <= {MAX_SRA_MIN_KMER_COUNT}", file=sys.stderr)
        return 0
    if not 0 <= opt.slice_index < opt.num_slice:
        print("Please specify: 0 <= --slice < --of", file=sys.stderr)
        return 0
    if not source_dir and not use_prefetch and not opt.stream_sra:
        print("Please specify an accession source (--source-dir, --prefetch or --stream)",
              file=sys.stderr)
        return 0
    if opt.device_build and opt.num_workers > 2:
        # One card: a parse thread and the device dispatcher; more
        # workers only contend for it.
        if opt.num_workers != MaestroOptions.num_workers:
            print("--device-build pipelines with 2 workers; capping --workers 2",
                  file=sys.stderr)
        opt.num_workers = 2
    if opt.device_build or opt.device_transpose:
        resolve_device()  # raises when the device is missing: no CPU fallback

    if use_prefetch:
        from ..io.ncbi_config import read_sra_repository

        repo = source_dir or read_sra_repository() or "."
        resolver = PrefetchResolver(repo, opt.max_sra_file_size_GB)
    elif source_dir:
        resolver = LocalFastaResolver(source_dir)
    else:
        resolver = StreamingResolver(opt.scratch_bloom_dir or ".")

    if worker_of:
        # Pull loop against a remote coordinator (the reference's
        # worker_main role over TCP instead of MPI).
        from ..parallel.remote import RemoteWorker

        host, _, port = worker_of.rpartition(":")
        n = RemoteWorker(opt, resolver, (host or "127.0.0.1", int(port))).run()
        print(f"Worker finished ({n} tasks)", file=sys.stderr)
        return 0

    if coordinator:
        from ..parallel.remote import run_distributed_maestro

        host, _, port = coordinator.rpartition(":")
        maestro = run_distributed_maestro(
            opt, resolver,
            num_local_workers=opt.num_workers,
            host=host or "127.0.0.1", port=int(port),
            task_timeout=task_timeout,
            # The address bound, on a line of its own: with port 0, where
            # the workers started beside this process find it.
            on_listening=lambda a: print(f"{LISTENING}{a[0]}:{a[1]}", file=sys.stderr,
                                         flush=True),
        )
    else:
        maestro = Maestro(opt, resolver)
        maestro.restore()
        maestro.run()

    print("Final status:", file=sys.stderr)
    for name, count in sorted(maestro.summary().items()):
        print(f"\t{name}: {count}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
