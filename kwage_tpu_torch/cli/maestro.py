"""maestro for the PyTorch + CUDA port: the flags of kwage_tpu.cli.maestro
(its ``usage`` and ``LONG_OPTS``), building the port's Maestro.

``--device-build`` (exact-count ingest) and ``--device-transpose`` (the
``.db`` pack) run on ``KWAGE_TORCH_DEVICE`` (default ``cuda``); without
a card they raise, as ``resolve_device`` does. ``--coordinator`` and
``--worker`` (the cross-host queue) are not ported yet: they exit 1.
"""

from __future__ import annotations

import getopt
import os
import sys

from kwage_tpu.cli._render import cli_errors
from kwage_tpu.cli.maestro import LONG_OPTS, usage
from kwage_tpu.core.hash import UNKNOWN_HASH, parse_hash_function_name
from kwage_tpu.core.params import MAX_SRA_MIN_KMER_COUNT
from kwage_tpu.parallel.maestro import (
    LocalFastaResolver,
    MaestroOptions,
    PrefetchResolver,
    StreamingResolver,
)

from ..parallel.maestro import Maestro
from ..utils.runtime import resolve_device

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
    scratch = source_dir = remote = ""
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
        elif flag in ("--coordinator", "--worker"):
            remote = flag
        elif flag in ("-h", "-?"):
            usage()
            return 0

    if remote:
        print(f"{remote} (the cross-host work queue) is not ported to kwage_tpu_torch "
              "yet; use kwage-maestro for it", file=sys.stderr)
        return 1

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
        from kwage_tpu.io.ncbi_config import read_sra_repository

        repo = source_dir or read_sra_repository() or "."
        resolver = PrefetchResolver(repo, opt.max_sra_file_size_GB)
    elif source_dir:
        resolver = LocalFastaResolver(source_dir)
    else:
        resolver = StreamingResolver(opt.scratch_bloom_dir or ".")

    maestro = Maestro(opt, resolver)
    maestro.restore()
    maestro.run()

    print("Final status:", file=sys.stderr)
    for name, count in sorted(maestro.summary().items()):
        print(f"\t{name}: {count}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
