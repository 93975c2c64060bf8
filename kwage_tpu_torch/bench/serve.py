"""Serving throughput and latency: the port's counterpart of
``tools/bench_resident.py``.

    python3 -m kwage_tpu_torch.bench.serve [--out PATH]

Builds the JAX tool's corpus (SCALE_N_ACC accessions, default 4350, of a
SCALE_GENOME-base genome each, default 28000, 160 bp reads at 4x; at L=18,
the reference's operating band, packed into 2048-filter .db files by the
port's ``maestro``, min_kmer_count 2, k=31), loads it into the port's
``ResidentSearcher`` on the device and its ``HostResidentSearcher``, and
drives the JAX tool's mixed batch of RESIDENT_NQ queries (default 512;
100-400 bp slices of known genomes, one in four random):

- warm queries/s at t=1.0 (complete match) and t=0.8 (counting): the
  median of 5 renders after a warm-up render; each render must equal the
  host searcher's bytes, or the run fails;
- latency: p50 and p99 ms of 20 warm renders (nearest rank: p99 of 20 is
  the slowest) at batches of the first 1, 8, 64 and 512 queries (those
  that RESIDENT_NQ holds), at both thresholds.

Prints the JAX tool's ``phase`` lines (generate, build, resident_batch,
done) and a ``latency`` line, beside the device's name. The last line is
{"phase": "done", "ok": ...}. Writes nothing but a temporary directory,
and the lines as one JSON list to ``--out PATH`` when given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..cli.kwage import find_db_files
from ..core import FilterInfo, str_to_accession
from ..io.inventory import write_inventory
from ..parallel.maestro import (
    STATUS_DATABASE_SUCCESS,
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
)
from ..search.resident import HostResidentSearcher, ResidentSearcher
from ._common import bench_device, check, print_device

N_ACC = int(os.environ.get("SCALE_N_ACC", "4350"))
NQ = int(os.environ.get("RESIDENT_NQ", "512"))
GENOME = int(os.environ.get("SCALE_GENOME", "28000"))
COV = 4
READ_LEN = 160
K = 31
WARM_RENDERS = 5
LATENCY_BATCHES = (1, 8, 64, 512)
LATENCY_RENDERS = 20


def log(results: list, phase: str, **kw) -> None:
    results.append({"phase": phase, **kw})
    print(json.dumps(results[-1]), flush=True)


def make_corpus(src: str, rng: np.random.Generator):
    """The JAX tool's corpus, written as FASTA under ``src``: returns the
    FilterInfo records and every 8th accession's genome (the queries'
    source)."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    n_reads = GENOME * COV // READ_LEN
    infos, genomes = [], []
    for i in range(N_ACC):
        acc = f"SRR7{i:06d}"
        genome = lut[rng.integers(0, 4, size=GENOME, dtype=np.uint8)]
        if i % 8 == 0:
            genomes.append(genome)
        starts = rng.integers(0, GENOME - READ_LEN + 1, size=n_reads)
        parts = []
        for r, st in enumerate(starts):
            parts.append(b">r%d\n" % r)
            parts.append(genome[st:st + READ_LEN].tobytes())
            parts.append(b"\n")
        with open(os.path.join(src, f"{acc}.fasta"), "wb") as f:
            f.write(b"".join(parts))
        infos.append(FilterInfo(run_accession=str_to_accession(acc),
                                number_of_bases=n_reads * READ_LEN))
    return infos, genomes


def make_queries(rng: np.random.Generator, genomes: list, nq: int) -> list[str]:
    """The JAX tool's mixed batch: 100-400 bp slices of known genomes (hit
    bearing), every fourth random (miss heavy)."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    queries = []
    for i in range(nq):
        ln = int(rng.choice([100, 150, 200, 300, 400]))
        if i % 4 == 3:
            queries.append(lut[rng.integers(0, 4, size=ln)].tobytes().decode())
        else:
            g = genomes[int(rng.integers(0, len(genomes)))]
            st = int(rng.integers(0, len(g) - ln))
            queries.append(g[st:st + ln].tobytes().decode())
    return queries


def nearest_rank(sorted_values: list[float], q: float) -> float:
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the phase lines here as one JSON list")
    args = ap.parse_args(argv)
    device = bench_device()
    label = print_device(device)
    results: list[dict] = []
    work = tempfile.mkdtemp(prefix="kwage_bench_serve.")
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(3)
        src = os.path.join(work, "fa")
        os.makedirs(src)
        infos, genomes = make_corpus(src, rng)
        inv = os.path.join(work, "inv.bin")
        write_inventory(inv, infos)
        log(results, "generate", accessions=N_ACC, dt_sec=time.perf_counter() - t0)

        opt = MaestroOptions(
            metadata_file=inv,
            scratch_bloom_dir=os.path.join(work, "bloom"),
            scratch_database_dir=os.path.join(work, "db"),
            status_file=os.path.join(work, "status.bin"),
            min_kmer_count=2, kmer_len=K, num_workers=2,
            lazy_inventory=True,
        )
        t0 = time.perf_counter()
        m = Maestro(opt, LocalFastaResolver(src))
        m.restore()
        m.run()
        n_built = int((m.status == STATUS_DATABASE_SUCCESS).sum())
        check(n_built == N_ACC, f"{n_built} of {N_ACC} filters built: {m.summary()}")
        log(results, "build", filters=n_built, dt_sec=time.perf_counter() - t0)

        queries = make_queries(rng, genomes, NQ)
        paths = find_db_files([opt.scratch_database_dir])
        t0 = time.perf_counter()
        searcher = ResidentSearcher(paths, device)
        dt_load = time.perf_counter() - t0
        host = HostResidentSearcher(paths)

        row = {"db_files": len(paths), "load_sec": dt_load, "batch_queries": NQ,
               "card": label}
        for name, thr in (("complete", 1.0), ("counting", 0.8)):
            out = searcher.render(queries, thr)      # warm-up
            samples = []
            for _ in range(WARM_RENDERS):
                t0 = time.perf_counter()
                again = searcher.render(queries, thr)
                samples.append(time.perf_counter() - t0)
                check(again == out, f"t={thr}: a warm render differs from the first")
            dt = sorted(samples)[len(samples) // 2]
            row[name] = {
                "warm_batch_sec": dt,
                "queries_per_s": NQ / dt,
                "ms_per_query": dt / NQ * 1e3,
                "byte_identical_to_host": out == host.render(queries, thr),
                "spread_s": sorted(samples),
            }
        log(results, "resident_batch", **row)

        latency = {"card": label, "renders": LATENCY_RENDERS}
        for name, thr in (("complete", 1.0), ("counting", 0.8)):
            latency[name] = {}
            for b in (b for b in LATENCY_BATCHES if b <= NQ):
                batch = queries[:b]
                searcher.render(batch, thr)          # warm-up
                ms = []
                for _ in range(LATENCY_RENDERS):
                    t0 = time.perf_counter()
                    searcher.render(batch, thr)
                    ms.append((time.perf_counter() - t0) * 1e3)
                ms.sort()
                latency[name][str(b)] = {"p50_ms": nearest_rank(ms, 0.5),
                                         "p99_ms": nearest_rank(ms, 0.99)}
        log(results, "latency", **latency)

        ok = all(row[n]["byte_identical_to_host"] for n in ("complete", "counting"))
        log(results, "done", ok=ok)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        return 0 if ok else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
