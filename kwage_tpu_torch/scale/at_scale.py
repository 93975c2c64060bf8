"""At-scale end-to-end proof at the reference's operating band: the port's
counterpart of ``tools/run_at_scale.py``.

    python3 -m kwage_tpu_torch.scale.at_scale [WORKDIR] [--out PATH]

One continuous ``maestro`` job over SCALE_N_ACC synthetic accessions (the
JAX tool's seed-0 corpus) sized so that the adaptive solver lands at L=18
(the reference's band, options.h:137-157: L in [18, 32], 2048 filters a
file, 64 GB cap):

1. run A (--halt-after SCALE_HALT) packs two full 2048-filter .db files
   and a forced-flush straggler; run B restarts from the checkpoint and
   packs the rest into a second partial;
2. the device build (``device_build``) of the first SCALE_DEVICE_N
   accessions into fresh scratch, cold then warm; sampled .bloom files
   equal the exact ground truth and the two runs' .db bytes are equal;
3. ``shape_check``: at least SCALE_REQUIRE_FULL full files at L=18 and two
   partials; ``merge_partials`` merges the partials (sha256 against the
   reference ``merge_db`` where it is built);
4. ``search_host`` (the port's host engine, against the reference
   ``kwage`` where it is built), ``search_device`` (``kwage-torch
   --device``) and ``search_device_resident`` (``ResidentSearcher``): each
   device output byte-identical to the host engine's.

Env knobs (the JAX tool's): SCALE_N_ACC (4350), SCALE_HALT (4200),
SCALE_GENOME (28000 bp: ~25k valid 31-mers, so BloomParam (L=18, h=5)),
SCALE_COV (4), SCALE_DEVICE_N (1024), SCALE_REQUIRE_FULL (2).

Runs on the card (``KWAGE_TORCH_DEVICE``, default ``cuda``; it raises
without one); ``KWAGE_TORCH_DEVICE=cpu`` runs the plain versions, for the
tests. Prints one JSON line a phase and writes the list to ``--out``
(default WORKDIR/at_scale.json). A WORKDIR given is kept; otherwise a
temporary one is made and removed. Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

from ..cli.kwage import find_db_files
from ..cli.kwage import main as kwage_main
from ..io.dbz_file import open_database
from ..io.sequence import iter_sequences
from ..parallel.maestro import (
    STATUS_DATABASE_SUCCESS,
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
)
from ..pipeline.merge_db import merge_databases
from ..search.resident import HostResidentSearcher, ResidentSearcher
from ..utils.runtime import resolve_device
from . import _corpus
from ._corpus import K, PhaseLog

N_ACC = int(os.environ.get("SCALE_N_ACC", "4350"))
HALT = int(os.environ.get("SCALE_HALT", "4200"))
GENOME = int(os.environ.get("SCALE_GENOME", "28000"))
COV = int(os.environ.get("SCALE_COV", "4"))
DEVICE_N = int(os.environ.get("SCALE_DEVICE_N", "1024"))
REQUIRE_FULL = int(os.environ.get("SCALE_REQUIRE_FULL", "2"))
MIN_COUNT = 2
THRESHOLD = 0.8


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def run_maestro(opt: MaestroOptions, src: str) -> tuple[int, float]:
    """One maestro run from the checkpoint: (accessions committed, s)."""
    t0 = time.perf_counter()
    m = Maestro(opt, LocalFastaResolver(src))
    m.restore()
    m.run()
    return int((m.status == STATUS_DATABASE_SUCCESS).sum()), time.perf_counter() - t0


def device_builds(log: PhaseLog, corpus, work: str, n_dev: int, mk_opt) -> bool:
    """The device build of the first ``n_dev`` accessions, cold then warm,
    each into fresh scratch: every accession committed, four sampled
    .bloom files equal to the exact ground truth, and the two runs' .db
    files byte-identical. Returns whether every check held."""
    ok, digests = True, []
    sample = sorted({0, 1, n_dev // 2, n_dev - 1})
    for label in ("cold", "warm"):
        opt = mk_opt(scratch_bloom_dir=os.path.join(work, f"dbloom_{label}"),
                     scratch_database_dir=os.path.join(work, f"ddb_{label}"),
                     status_file=os.path.join(work, f"dstatus_{label}.bin"),
                     limit_num_download=n_dev, device_build=True, save_bloom=True)
        for old in (opt.scratch_bloom_dir, opt.scratch_database_dir):
            shutil.rmtree(old, ignore_errors=True)   # an earlier run's, on a kept workdir
        if os.path.exists(opt.status_file):
            os.remove(opt.status_file)
        n, dt = run_maestro(opt, corpus.src)
        truth = all(_corpus.bloom_matches_truth(
            os.path.join(opt.scratch_bloom_dir, f"{corpus.accessions[i]}.bloom"),
            os.path.join(corpus.src, f"{corpus.accessions[i]}.fasta"),
            opt.min_kmer_count, opt.min_log_2_filter_len, opt.max_log_2_filter_len)
            for i in sample)
        dbs = sorted(os.listdir(opt.scratch_database_dir))
        digests.append([sha256(os.path.join(opt.scratch_database_dir, f)) for f in dbs])
        ok &= n == n_dev and truth
        log.log(f"maestro_device_build_{label}", committed=n, dt_sec=dt,
                filters_per_sec=n / dt, sampled_blooms_equal_ground_truth=truth,
                db_files=dbs)
        for done in (opt.scratch_bloom_dir, opt.scratch_database_dir):
            shutil.rmtree(done, ignore_errors=True)
    same = digests[0] == digests[1]
    log.log("device_build_runs_equal", db_sha256_equal=same)
    return ok and same


def merge_with_oracle(partials: list[str], work: str) -> tuple[str, bool | None]:
    """merge_db the partials in place; the merged file and whether its
    sha256 equals the reference merge_db's on copies (None: not built)."""
    oracle = _corpus.oracle_binary("merge_db")
    copies = []
    if oracle:
        odir = os.path.join(work, "omerge")
        os.makedirs(odir)
        for p in partials:
            copies.append(os.path.join(odir, os.path.basename(p)))
            shutil.copy(p, copies[-1])
    merge_databases(partials, verbose=False)
    remaining = [p for p in partials if os.path.exists(p)]
    if len(remaining) != 1:
        raise RuntimeError(f"merge_db left {remaining}")
    same = None
    if oracle:
        proc = subprocess.run([oracle, *copies], capture_output=True, text=True)
        survived = [p for p in copies if os.path.exists(p)]
        same = (proc.returncode == 0 and len(survived) == 1
                and sha256(survived[0]) == sha256(remaining[0]))
        shutil.rmtree(os.path.dirname(copies[0]), ignore_errors=True)
    return remaining[0], same


def kwage_bytes(args: list[str], out: str) -> str:
    """The port's kwage CLI, in this process, its output file's text."""
    rc = kwage_main(args + ["-o", out])
    if rc != 0:
        raise RuntimeError(f"kwage-torch {' '.join(args)} exited {rc}")
    with open(out) as f:
        return f.read()


def search_oracle(corpus_dir: str, qfasta: str, host_out: str) -> dict:
    """The reference kwage over the same corpus and queries, where it is
    built: its seconds and whether its bytes equal the host engine's."""
    oracle = _corpus.oracle_binary("kwage")
    if oracle is None:
        return {"oracle": "absent"}
    t0 = time.perf_counter()
    proc = subprocess.run([oracle, "-d", corpus_dir, "-t", str(THRESHOLD), "-i", qfasta],
                          capture_output=True, text=True, timeout=7200)
    return {"oracle_dt_sec": time.perf_counter() - t0,
            "byte_identical_to_oracle": proc.returncode == 0 and proc.stdout == host_out}


def search_phases(log: PhaseLog, device, corpus_dir: str, qfasta: str, work: str) -> bool:
    """search_host, search_device, search_device_resident over one corpus
    directory; returns whether every byte check held."""
    base = ["-d", corpus_dir, "-t", str(THRESHOLD), "-i", qfasta]
    t0 = time.perf_counter()
    host_out = kwage_bytes(base, os.path.join(work, "host.out"))
    dt = time.perf_counter() - t0
    oracle = search_oracle(corpus_dir, qfasta, host_out)
    queries = [s for _, s in iter_sequences(qfasta)]
    log.log("search_host", queries=len(queries), dt_sec=dt,
            any_hits='"run"' in host_out, **oracle)

    t0 = time.perf_counter()
    dev_out = kwage_bytes(base + ["--device"], os.path.join(work, "device.out"))
    same = dev_out == host_out
    log.log("search_device", dt_sec=time.perf_counter() - t0, byte_identical_to_host=same)

    paths = find_db_files([corpus_dir])
    want = HostResidentSearcher(paths).render(queries, THRESHOLD)
    t0 = time.perf_counter()
    searcher = ResidentSearcher(paths, device)
    load = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = searcher.render(queries, THRESHOLD)
    dt_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = searcher.render(queries, THRESHOLD)
    dt_warm = time.perf_counter() - t0
    resident = searcher.resident_bytes
    del searcher
    res_same = first == want and second == want
    log.log("search_device_resident", load_sec=load, resident_bytes=resident,
            first_query_sec=dt_first, warm_query_sec=dt_warm,
            byte_identical_to_host=res_same)
    return (same and res_same and oracle.get("byte_identical_to_oracle") is not False)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", help="work here and keep it")
    ap.add_argument("--out", help="the phase lines as one JSON list (default "
                                  "WORKDIR/at_scale.json)")
    args = ap.parse_args(argv)
    device = resolve_device()
    log = PhaseLog(device)
    work = args.workdir or tempfile.mkdtemp(prefix="kwage_scale_")
    os.makedirs(work, exist_ok=True)
    try:
        t0 = time.perf_counter()
        corpus = _corpus.generate(work, N_ACC, GENOME, COV, seed=0, prefix="SRR9",
                                  query_at=(5, 2500, 4150, N_ACC - 5))
        log.log("generate", accessions=N_ACC, bp_per_acc=corpus.bp_per_acc,
                total_mbp=N_ACC * corpus.bp_per_acc / 1e6, device=str(device),
                dt_sec=time.perf_counter() - t0)

        def mk_opt(**kw) -> MaestroOptions:
            base = dict(metadata_file=corpus.inv,
                        scratch_bloom_dir=os.path.join(work, "bloom"),
                        scratch_database_dir=os.path.join(work, "db"),
                        status_file=os.path.join(work, "status.bin"),
                        min_kmer_count=MIN_COUNT, kmer_len=K, num_workers=2,
                        lazy_inventory=True)
            base.update(kw)
            return MaestroOptions(**base)

        db_dir = os.path.join(work, "db")
        n_a, dt = run_maestro(mk_opt(limit_num_download=HALT), corpus.src)
        log.log("maestro_run_A", committed=n_a, dt_sec=dt, filters_per_sec=n_a / dt,
                db_files=sorted(os.listdir(db_dir)))
        n_b, dt = run_maestro(mk_opt(limit_num_download=0), corpus.src)
        if n_b != N_ACC:
            raise RuntimeError(f"run B committed {n_b} of {N_ACC}")
        db_files = sorted(os.listdir(db_dir))
        log.log("maestro_run_B_restart", committed=n_b - n_a, dt_sec=dt,
                filters_per_sec=(n_b - n_a) / dt, db_files=db_files)

        ok = device_builds(log, corpus, work, min(DEVICE_N, N_ACC), mk_opt)

        headers = {f: open_database(os.path.join(db_dir, f)).header for f in db_files}
        sizes = {f: (h.num_filter, h.log_2_filter_len) for f, h in headers.items()}
        full = [f for f, (n, L) in sizes.items() if n == 2048 and L == 18]
        partial = [f for f, (n, _) in sizes.items() if n < 2048]
        shape_ok = len(full) >= REQUIRE_FULL and len(partial) >= 2
        log.log("shape_check", files={f: list(v) for f, v in sizes.items()}, ok=shape_ok)
        if not shape_ok:
            raise RuntimeError(f"shape check: {sizes}")

        t0 = time.perf_counter()
        corpus_dir = os.path.join(work, "corpus")
        os.makedirs(corpus_dir)
        for f in db_files:
            shutil.copy(os.path.join(db_dir, f), os.path.join(corpus_dir, f))
        merged, oracle_same = merge_with_oracle(
            [os.path.join(corpus_dir, f) for f in partial], work)
        log.log("merge_partials", merged_filters=open_database(merged).header.num_filter,
                oracle_sha_identical=oracle_same if oracle_same is not None else "absent",
                dt_sec=time.perf_counter() - t0)
        ok &= oracle_same is not False

        qfasta = os.path.join(work, "queries.fasta")
        _corpus.write_queries(qfasta, corpus.queries)
        ok &= search_phases(log, device, corpus_dir, qfasta, work)
        log.log("done", ok=bool(ok))
        log.save(args.out or os.path.join(work, "at_scale.json"))
        return 0 if ok else 1
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
