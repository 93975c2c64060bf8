"""Build-side throughput: the port's counterpart of ``bench_build.py``.

    python3 -m kwage_tpu_torch.bench.build

Bloom filters built/s and ingest Mbp/s through the whole ``maestro``
pipeline (resolve -> count/threshold -> adaptive sizing -> .bloom ->
transpose -> .db), host mode (the counting-Bloom host builder) against
device mode (the exact count on the device), with ``bench_build.py``'s
corpus (``make_corpus``: the same FASTA bytes), ``MaestroOptions`` and
device warm-up (one same-shaped ``build_blooms_device_batch`` call); the
host mode is warmed too (the host library's build at first use, one
accession's host build), which ``bench_build.py`` leaves in its one host
run. Env overrides:
BUILD_N_ACC (default 32), BUILD_BP (bases an accession, default 300000),
BUILD_WORKERS (default 4), BUILD_DEVICE_BATCH (default 16).

Host and device runs alternate ROUNDS times (host, device, host, ...),
each on fresh scratch, and each mode reports its median: host times on a
shared machine vary between runs, and a best-of would set a lucky run
beside a plain one. Every run is printed on its own line. Every accession
must reach STATUS_DATABASE_SUCCESS in every run, and every filter of the
last device run's .db files must equal its exact ground truth
(``_common.exact_bloom``), or the run fails. Then one line a mode with
``bench_build.py``'s keys: metric, value, unit, mbp_per_sec.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

from ..core import FilterInfo, accession_to_str, str_to_accession
from ..io.dbz_file import open_database
from ..io.inventory import write_inventory
from ..io.sequence import iter_sequences
from ..native import available as native_available
from ..parallel.maestro import (
    STATUS_DATABASE_SUCCESS,
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
)
from ..pipeline.make_bloom import build_blooms_device_batch, build_bloom_from_file
from ._common import bench_device, check, exact_bloom, print_device

N_ACC = int(os.environ.get("BUILD_N_ACC", "32"))
BP = int(os.environ.get("BUILD_BP", "300000"))
WORKERS = int(os.environ.get("BUILD_WORKERS", "4"))
DEVICE_BATCH = int(os.environ.get("BUILD_DEVICE_BATCH", "16"))
READ_LEN = 300
ROUNDS = 3


def make_corpus(n_acc: int = N_ACC, bp: int = BP, seed: int = 0) -> list[tuple[str, np.ndarray]]:
    """``bench_build.py``'s corpus: per accession its name and its reads,
    ASCII uint8 [bp // 300, 300], sampled from a genome of its own at ~4x
    coverage, so true k-mers recur (min_kmer_count has signal to keep). The
    numpy calls are ``bench_build.py``'s, in its order."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    corpus = []
    for i in range(n_acc):
        n_reads = bp // READ_LEN
        genome = lut[rng.integers(0, 4, size=max(bp // 4, READ_LEN), dtype=np.uint8)]
        starts = rng.integers(0, genome.size - READ_LEN + 1, size=n_reads)
        corpus.append((f"SRR5{i:06d}", genome[starts[:, None] + np.arange(READ_LEN)]))
    return corpus


def fasta_bytes(reads: np.ndarray) -> bytes:
    """One record a read: >r<i>, then the read on one line."""
    return b"".join(b">r%d\n%s\n" % (r, read.tobytes()) for r, read in enumerate(reads))


def options(work: str, scratch: str, device_build: bool) -> MaestroOptions:
    """``bench_build.py``'s options for one run into ``scratch``."""
    return MaestroOptions(
        metadata_file=os.path.join(work, "inv.bin"),
        scratch_bloom_dir=os.path.join(scratch, "bloom"),
        scratch_database_dir=os.path.join(scratch, "db"),
        status_file=os.path.join(scratch, "status.bin"),
        min_kmer_count=2,
        min_log_2_filter_len=18,
        max_log_2_filter_len=24,
        min_log_2_count_len=18,
        max_log_2_count_len=24,
        # Device mode: the scheduler runs its own two-stage pipeline (1
        # parse thread + 1 device dispatcher); num_workers only sizes the
        # db-packing pool there.
        num_workers=2 if device_build else WORKERS,
        device_build=device_build,
        device_batch=DEVICE_BATCH,
    )


def db_filters(db_dir: str):
    """(accession, param, packed bits) of every filter in the .db files of
    ``db_dir``: filter i is bit i % 8 of byte i // 8 of each slice row."""
    for name in sorted(os.listdir(db_dir)):
        reader = open_database(os.path.join(db_dir, name))
        slices = reader.read_slices()
        for i in range(reader.header.num_filter):
            acc = accession_to_str(reader.read_filter_info(i).run_accession)
            bits = (slices[:, i >> 3] >> (i & 7)) & 1
            yield acc, reader.header.param, np.packbits(bits, bitorder="little")


def main() -> int:
    device = bench_device()
    label = print_device(device)
    work = tempfile.mkdtemp(prefix="kwage_bench_build.")
    try:
        src = os.path.join(work, "fa")
        os.makedirs(src)
        corpus = make_corpus()
        accs = [acc for acc, _ in corpus]
        for acc, reads in corpus:
            with open(os.path.join(src, f"{acc}.fasta"), "wb") as f:
                f.write(fasta_bytes(reads))
        write_inventory(os.path.join(work, "inv.bin"),
                        [FilterInfo(run_accession=str_to_accession(a)) for a in accs])

        # Set-up before the runs, so that the figures are the steady
        # state's: the host library (g++ at first use), one host build of
        # an accession, and one same-shaped device batch build.
        t0 = time.perf_counter()
        check(native_available(), "the host library (native/kwage_native.cpp) did not build")
        t_lib = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = options(work, os.path.join(work, "warm"), False)
        build_bloom_from_file(os.path.join(src, f"{accs[0]}.fasta"), warm.build_options(),
                              FilterInfo())
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = options(work, os.path.join(work, "warm"), True)
        jobs = [([s for _, s in iter_sequences(os.path.join(src, f"{a}.fasta"))], FilterInfo())
                for a in accs[: warm.device_batch]]
        build_blooms_device_batch(jobs, warm.build_options())
        print(json.dumps({"setup": {"host_library_s": t_lib, "host_warmup_s": t_host,
                                    "device_warmup_s": time.perf_counter() - t0}}), flush=True)

        walls = {"host": [], "device": []}
        for rnd in range(ROUNDS):
            for mode, device_build in (("host", False), ("device", True)):
                scratch = os.path.join(work, f"{mode}{rnd}")
                opt = options(work, scratch, device_build)
                m = Maestro(opt, LocalFastaResolver(src))
                m.restore()
                t0 = time.perf_counter()
                m.run()
                dt = time.perf_counter() - t0
                ok = sum(1 for s in m.status if s == STATUS_DATABASE_SUCCESS)
                check(ok == len(accs), f"{mode} run {rnd}: {ok} of {len(accs)} accessions "
                                       f"built: {m.summary()}")
                walls[mode].append(dt)
                print(json.dumps({"run": mode, "round": rnd, "seconds": dt, "filters": ok,
                                  "filters_per_s": ok / dt, "mbp_per_sec": ok * BP / dt / 1e6}),
                      flush=True)
                if rnd < ROUNDS - 1 or not device_build:
                    shutil.rmtree(scratch, ignore_errors=True)

        # The last device run: every filter == its exact ground truth.
        opt = options(work, os.path.join(work, f"device{ROUNDS - 1}"), True)
        reads = dict(corpus)
        seen = set()
        for acc, param, bits in db_filters(opt.scratch_database_dir):
            t_param, t_bits, _ = exact_bloom(
                reads[acc], opt.kmer_len, opt.min_kmer_count, opt.false_positive_probability,
                opt.min_log_2_filter_len, opt.max_log_2_filter_len)
            check(param == t_param, f"{acc}: param {param} != ground truth {t_param}")
            check(bits.tobytes() == t_bits.tobytes(), f"{acc}: bits differ from the ground truth")
            seen.add(acc)
        check(seen == set(accs), f"{len(seen)} of {len(accs)} filters in the device .db files")
        print(json.dumps({"check": "device .db filters == exact ground truth",
                          "filters": len(seen)}), flush=True)

        for mode in ("host", "device"):
            dt = statistics.median(walls[mode])
            print(json.dumps({
                "metric": f"bloom_filters_built_per_sec_{mode}",
                "value": len(accs) / dt,
                "unit": f"filters/s ({BP} bp each; {WORKERS} workers; end-to-end incl. "
                        f"transpose; median of {ROUNDS} runs alternated with the other "
                        f"mode; {label})",
                "mbp_per_sec": len(accs) * BP / dt / 1e6,
            }), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
