"""Production filter-length proof: the port's counterpart of
``tools/run_at_scale_prodL.py`` and ``tools/run_prodL_device.py``, in one
program.

    python3 -m kwage_tpu_torch.scale.prod_l [WORKDIR] [--out PATH]
    python3 -m kwage_tpu_torch.scale.prod_l --device-only WORKDIR [--out PATH]

One continuous ``maestro`` job with the filter length pinned to SCALE_L
(26: --len.min = --len.max, a production configuration; the solver would
otherwise need ~6.4 M distinct k-mers an accession to land there), over
the JAX tool's seed-1 corpus of SCALE_N_ACC accessions:

- ``quota_check``: min(2048, 64 GiB * 8 / 2^L) at L 24-32 (2048 at 26,
  1024 at 29, 128 at 32);
- run A (--halt-after SCALE_HALT) packs one full quota file, 2048 filters
  x 8 MiB = 16 GiB, and a forced-flush partial; run B restarts and packs
  the rest; ``shape_check`` (every file at L=26, SCALE_REQUIRE_FULL full
  ones); ``merge_partials``; ``search_host`` (against the reference kwage
  where it is built);
- ``search_device``: ``kwage-torch --device`` over the corpus (of the
  16 GiB file, wider than the 8 GiB fusion budget, only the rows the
  queries touch go to the card), byte-identical to the host engine;
- ``sharded_wave_search``: the mesh wave plan (``build_sharded_groups``)
  with the budget from the card's free memory (``torch.cuda.mem_get_info``,
  80% of it a shard) -- an 80 GB card holds the corpus whole, so it
  records ``forced_by_memory_pressure`` false -- and again under half the
  widest file's matrix a shard (8 GiB), which forces two or more waves; hit lists
  equal to the host engine's;
- ``maestro_device_build_{cold,warm}`` at L=26 (SCALE_DEVICE_N
  accessions): sampled .bloom files equal to the exact ground truth, the
  two runs' .db bytes equal.

``--device-only WORKDIR`` reruns the device phases (and the host search
they are held to) over a kept WORKDIR, as ``run_prodL_device.py`` does;
PRODL_SKIP_SEARCH=1 reruns only the builds.

Env knobs (the JAX tools'): SCALE_N_ACC (2268), SCALE_HALT (2100),
SCALE_GENOME (30000), SCALE_L (26), SCALE_DEVICE_N (256),
SCALE_REQUIRE_FULL (1), SCALE_KEEP ("1" keeps a temporary WORKDIR),
PRODL_SKIP_SEARCH. Needs 40 GiB free in WORKDIR and 16 GiB of host memory
at the defaults (it fails, naming the shortfall, without them). Runs on the card unless
``KWAGE_TORCH_DEVICE=cpu`` and raises without one. Prints one JSON line a
phase and writes the list to ``--out`` (default WORKDIR/prod_l.json).
Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import torch

from ..cli.kwage import find_db_files
from ..core.params import filters_per_file_quota
from ..io.dbz_file import open_database
from ..io.sequence import iter_sequences
from ..parallel.maestro import MaestroOptions
from ..parallel.mesh import make_search_mesh
from ..parallel.sharded_search import build_sharded_groups, search_sharded_groups
from ..search.engine import search_database_files
from ..utils.runtime import resolve_device
from . import _corpus
from ._corpus import K, PhaseLog
from .at_scale import device_builds, kwage_bytes, merge_with_oracle, run_maestro, search_oracle

N_ACC = int(os.environ.get("SCALE_N_ACC", "2268"))
HALT = int(os.environ.get("SCALE_HALT", "2100"))
GENOME = int(os.environ.get("SCALE_GENOME", "30000"))
LPROD = int(os.environ.get("SCALE_L", "26"))
DEVICE_N = int(os.environ.get("SCALE_DEVICE_N", "256"))
REQUIRE_FULL = int(os.environ.get("SCALE_REQUIRE_FULL", "1"))
COV = 4
MIN_COUNT = 2
THRESHOLD = 0.8


def canon(res: dict) -> dict:
    return {qid: [(m.num_kmers_found, m.num_query_kmer, m.subject_info.run_accession)
                  for m in lst] for qid, lst in res.items() if lst}


def wave_plan(corpus_dir: str, qfasta: str, budget: int, mesh, host: dict) -> dict:
    """The mesh wave plan over every .db of the corpus under ``budget``
    bytes a shard: groups, waves, bytes a wave, whether the corpus had to
    stream, load and search seconds, and whether the hit lists equal the
    host engine's (``host``: its canonical results)."""
    paths = find_db_files([corpus_dir])
    queries = [(i, s) for i, (_, s) in enumerate(iter_sequences(qfasta))]
    n_shards = mesh.shape["filters"]
    t0 = time.perf_counter()
    groups = build_sharded_groups(mesh, paths, budget_bytes=budget)
    dt_load = time.perf_counter() - t0
    waves = [ncols * sdb.filter_len * 4 for sdb, _ in groups for _, ncols, _ in sdb._waves]
    t0 = time.perf_counter()
    got = search_sharded_groups(groups, paths, queries, THRESHOLD)
    dt_search = time.perf_counter() - t0
    streamed = [sdb.db is None for sdb, _ in groups]
    del groups
    return {"budget_bytes_a_shard": budget, "n_shards": n_shards,
            "fused_matrix_bytes": sum(waves), "n_groups": len(streamed),
            "groups_streamed": streamed, "n_waves": len(waves), "bytes_per_wave": waves,
            "forced_by_memory_pressure": any(streamed), "load_plus_upload_sec": dt_load,
            "search_sec": dt_search, "hit_lists_equal_host": canon(got) == host}


def device_phases(log: PhaseLog, device, work: str, src_accs, skip_search: bool,
                  host_out: str | None = None) -> bool:
    """search_device, the two wave plans and the L=26 device builds over a
    workdir that holds db/, queries.fasta, fa/ and inv.bin; ``host_out``:
    the host engine's bytes for the queries (searched again when None)."""
    corpus_dir = os.path.join(work, "db")
    qfasta = os.path.join(work, "queries.fasta")
    ok = True
    if not skip_search:
        base = ["-d", corpus_dir, "-t", str(THRESHOLD), "-i", qfasta]
        if host_out is None:
            t0 = time.perf_counter()
            host_out = kwage_bytes(base, os.path.join(work, "host.out"))
            log.log("search_host_rerun", dt_sec=time.perf_counter() - t0)
        t0 = time.perf_counter()
        dev_out = kwage_bytes(base + ["--device"], os.path.join(work, "device.out"))
        same = dev_out == host_out
        log.log("search_device", dt_sec=time.perf_counter() - t0, byte_identical_to_host=same)
        ok &= same

        queries = [(i, s) for i, (_, s) in enumerate(iter_sequences(qfasta))]
        host = canon(search_database_files(find_db_files([corpus_dir]), queries, THRESHOLD))
        mesh = make_search_mesh()
        if device.type == "cuda":
            free, total = torch.cuda.mem_get_info(device)
        else:
            free = total = 16 << 30   # the CPU: a stand-in, not a card's figure
        rec = wave_plan(corpus_dir, qfasta, int(free * 0.8), mesh, host)
        log.log("sharded_wave_search", device_free_bytes=free, device_total_bytes=total, **rec)
        ok &= rec["hit_lists_equal_host"]
        # A stated budget a shard under which the widest file cannot be one
        # wave: half its matrix (8 GiB for the full file at L=26).
        widest = max(r.header.filter_len * -(-r.header.slice_size // 4) * 4
                     for r in map(open_database, find_db_files([corpus_dir])))
        rec = wave_plan(corpus_dir, qfasta, widest // 2, mesh, host)
        log.log("sharded_wave_search_budget", **rec)
        ok &= rec["hit_lists_equal_host"] and rec["n_waves"] >= 2

    def mk_opt(**kw) -> MaestroOptions:
        return MaestroOptions(metadata_file=os.path.join(work, "inv.bin"),
                              min_kmer_count=MIN_COUNT, kmer_len=K, num_workers=2,
                              lazy_inventory=True, min_log_2_filter_len=LPROD,
                              max_log_2_filter_len=LPROD, **kw)

    corpus = _corpus.Corpus(os.path.join(work, "fa"), os.path.join(work, "inv.bin"),
                            src_accs, 0, [])
    ok &= device_builds(log, corpus, work, min(DEVICE_N, len(src_accs)), mk_opt)
    return ok


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", help="work here and keep it")
    ap.add_argument("--device-only", metavar="WORKDIR",
                    help="rerun the device phases over a kept workdir")
    ap.add_argument("--out", help="the phase lines as one JSON list (default "
                                  "WORKDIR/prod_l.json)")
    args = ap.parse_args(argv)
    device = resolve_device()
    log = PhaseLog(device)
    skip_search = os.environ.get("PRODL_SKIP_SEARCH") == "1"
    if args.device_only:
        work = args.device_only
        for name in ("db", "queries.fasta", "fa", "inv.bin"):
            if not os.path.exists(os.path.join(work, name)):
                raise SystemExit(f"prod_l: {work} has no {name}: run prod_l there first")
        accs = sorted(f[:-len(".fasta")] for f in os.listdir(os.path.join(work, "fa")))
        ok = device_phases(log, device, work, accs, skip_search)
        log.log("device_done", ok=bool(ok))
        log.save(args.out or os.path.join(work, "prod_l_device.json"))
        return 0 if ok else 1

    work = args.workdir or tempfile.mkdtemp(prefix="kwage_prodL_")
    os.makedirs(work, exist_ok=True)
    keep = args.workdir is not None or os.environ.get("SCALE_KEEP") == "1"
    try:
        # Disk: every accession's .bloom and its share of a .db, and the
        # device builds' (40 GiB at the defaults); memory: the full file,
        # so that its pages stay cached between the searches (16 GiB).
        filter_bytes = (1 << LPROD) // 8
        machine = _corpus.require_machine(
            work, 2 * filter_bytes * (N_ACC + DEVICE_N),
            filter_bytes * min(N_ACC, filters_per_file_quota(LPROD)))
        t0 = time.perf_counter()
        corpus = _corpus.generate(work, N_ACC, GENOME, COV, seed=1, prefix="SRR8",
                                  query_at=(7, 1024, HALT + 10, N_ACC - 3))
        log.log("generate", accessions=N_ACC, L=LPROD, filter_mb=(1 << LPROD) / 8e6,
                full_file_gib=filters_per_file_quota(LPROD) * (1 << LPROD) / 8 / 2**30,
                device=str(device), dt_sec=time.perf_counter() - t0, **machine)
        log.log("quota_check", quotas=_corpus.quota_table())

        def mk_opt(**kw) -> MaestroOptions:
            return MaestroOptions(
                metadata_file=corpus.inv, scratch_bloom_dir=os.path.join(work, "bloom"),
                scratch_database_dir=os.path.join(work, "db"),
                status_file=os.path.join(work, "status.bin"), min_kmer_count=MIN_COUNT,
                kmer_len=K, num_workers=2, lazy_inventory=True,
                min_log_2_filter_len=LPROD, max_log_2_filter_len=LPROD, **kw)

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

        sizes = {}
        for f in db_files:
            h = open_database(os.path.join(db_dir, f)).header
            sizes[f] = (h.num_filter, h.log_2_filter_len)
        quota = filters_per_file_quota(LPROD)
        full = [f for f, (n, L) in sizes.items() if n == quota and L == LPROD]
        partial = [f for f, (n, _) in sizes.items() if n < quota]
        shape_ok = (len(full) >= REQUIRE_FULL and len(partial) >= 2
                    and all(L == LPROD for _, L in sizes.values()))
        log.log("shape_check", files={f: list(v) for f, v in sizes.items()},
                full_file_bytes=os.path.getsize(os.path.join(db_dir, full[0])) if full else None,
                ok=shape_ok)
        if not shape_ok:
            raise RuntimeError(f"shape check: {sizes}")

        t0 = time.perf_counter()
        merged, oracle_same = merge_with_oracle([os.path.join(db_dir, f) for f in partial], work)
        log.log("merge_partials", merged_filters=open_database(merged).header.num_filter,
                oracle_sha_identical=oracle_same if oracle_same is not None else "absent",
                dt_sec=time.perf_counter() - t0)
        ok = oracle_same is not False

        qfasta = os.path.join(work, "queries.fasta")
        _corpus.write_queries(qfasta, corpus.queries)
        base = ["-d", db_dir, "-t", str(THRESHOLD), "-i", qfasta]
        t0 = time.perf_counter()
        host_out = kwage_bytes(base, os.path.join(work, "host.out"))
        dt = time.perf_counter() - t0
        oracle = search_oracle(db_dir, qfasta, host_out)
        log.log("search_host", queries=len(corpus.queries), dt_sec=dt,
                any_hits='"run"' in host_out, **oracle)
        ok &= oracle.get("byte_identical_to_oracle") is not False

        ok &= device_phases(log, device, work, corpus.accessions, skip_search, host_out)
        log.log("done", ok=bool(ok))
        log.save(args.out or os.path.join(work, "prod_l.json"))
        return 0 if ok else 1
    finally:
        if not keep:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
