"""The one-shot device search call by route, and the card's
host-to-device rates.

    python3 -m kwage_tpu_torch.bench.search_routes [--work DIR] [--log2-len 22]
        [--files 8] [--shares 0.023,0.1,0.25,0.5] [--calls 3] [--host] [--mesh N]
        [--out PATH]

The corpus: one .db of 2048 random filters (each bit set with p = 1/2)
at L = 2^log2-len, k=31, 5 hashes, hard-linked ``--files`` times, so the
files fuse side by side: at the defaults 8 x 1 GiB, the shape of
``chip_smoke.py`` phase 2 (8 GiB fused); ``--log2-len 26 --files 1`` is
one 16 GiB quota file, phase 14's. It is made once in WORK and reused
from there (default: a temporary directory, removed at exit).

For each share in ``--shares``: a batch of random 400 bp queries
(``default_rng`` seeded by the share's position), as many as put the
batch's distinct slice rows at about that share of L, searched at
THRESHOLD by ``ops.search.search_files_device``, ``--calls`` calls in
turn by each route the tree has: "gather" (``GATHER_SHARE`` set to 1, so
only the touched rows go to the card), "full" (``GATHER_SHARE`` 0: the
whole chunk) and "rule" (``GATHER_SHARE`` as the tree has it: the route
``search_chunk``'s rule chooses, printed as ``taken``). A tree without
routes runs its one route, named "full". The
first call of the process follows only a warm-up of the kernels on a
tiny matrix, so it carries the first page-locked allocation, as a
``kwage --device`` call would. Every route's hit lists equal the first
route's; with ``--host``, the first share's also equal the host
engine's, whose wall is printed beside them. With ``--mesh N``, each call
is followed by the one-shot mesh search (``parallel.sharded_search.
sharded_search_files``) on N logical shards of the card by the same
route, a "mesh_call" line with the same hits.

One JSON line a call (wall, the rows, their share of L, the steps of the
call's ``profile``), and first the host-to-device rates of a 1 GiB copy
(``h2d_rates``), each line with the card's name and power limit. Runs on
the card (exits 1 without one, unless ``KWAGE_TORCH_DEVICE=cpu``: the
plain versions, host clock, for the tests).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..core import FilterInfo, str_to_accession
from ..core.params import BloomParam
from ..io.db_file import write_db_file_streaming
from ..ops import search as ts
from ..search.engine import search_database_files
from ._common import bench_device, check, out_path, phase_log

NUM_FILTER = 2048
KMER_LEN = 31
NUM_HASH = 5
QUERY_BP = 400
# About 1-2% of (query, filter) pairs hit on random filters at p = 1/2 and
# 5 hashes: non-empty hit lists that stay short.
THRESHOLD = 0.05
H2D_BYTES = 1 << 30
WRITE_ROWS = 1 << 20   # slice rows drawn and written at a time


def h2d_rates(device: torch.device, nbytes: int = H2D_BYTES, reps: int = 3) -> dict | None:
    """Host-to-device bytes/s (in GB/s) of a ``nbytes`` copy from
    page-locked and from pageable (touched) host memory, CUDA events
    around ``reps`` copies after a warm-up one, and the page-locked
    buffer's allocation seconds. None on the CPU."""
    if device.type != "cuda":
        return None
    t0 = time.perf_counter()
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    rates = {"pin_alloc_s": time.perf_counter() - t0}
    pageable = torch.from_numpy(np.ones(nbytes, dtype=np.uint8))
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    for name, src in (("pinned", pinned), ("pageable", pageable)):
        dev.copy_(src, non_blocking=True)
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            dev.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        rates[f"{name}_GBps"] = reps * nbytes / (start.elapsed_time(end) / 1e3) / 1e9
    return rates


def make_corpus(work: str, log2_len: int, files: int) -> list[str]:
    """``files`` hard links of one random .db in ``work`` (made once)."""
    first = os.path.join(work, f"routes_L{log2_len}.0.db")
    if not os.path.exists(first):
        param = BloomParam(kmer_len=KMER_LEN, log_2_filter_len=log2_len, num_hash=NUM_HASH)
        rng = np.random.default_rng(log2_len)
        L, row = 1 << log2_len, NUM_FILTER // 8
        chunks = (rng.integers(0, 256, size=(min(WRITE_ROWS, L - r0), row), dtype=np.uint8)
                  for r0 in range(0, L, WRITE_ROWS))
        infos = [FilterInfo(run_accession=str_to_accession(f"SRR{2000000 + i}"))
                 for i in range(NUM_FILTER)]
        write_db_file_streaming(first + ".tmp", param, chunks, infos, NUM_FILTER)
        os.replace(first + ".tmp", first)
    paths = [first]
    for i in range(1, files):
        paths.append(os.path.join(work, f"routes_L{log2_len}.{i}.db"))
        if not os.path.exists(paths[-1]):
            os.link(first, paths[-1])
    return paths


def batch_for_share(share: float, log2_len: int, seed: int) -> tuple[list, int]:
    """Random 400 bp queries whose distinct slice rows are about ``share``
    of L (a query's k-mers hash to QUERY_BP - k + 1 rows a seed), and the
    rows they touch."""
    L = 1 << log2_len
    per_query = (QUERY_BP - KMER_LEN + 1) * NUM_HASH
    n = max(1, int(np.ceil(-L * np.log1p(-share) / per_query)))
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, QUERY_BP), dtype=np.uint8)
    seqs = [s.decode() for s in np.frombuffer(b"ACGT", np.uint8)[codes].view(f"S{QUERY_BP}")
            .ravel()]
    idx, _, _ = ts.make_query_batch(seqs, KMER_LEN, NUM_HASH, log2_len)
    return list(enumerate(seqs)), len(np.unique(idx))


def routes_of_tree() -> list[tuple[str, float | None]]:
    """(route, GATHER_SHARE to set) for each route this tree's search has."""
    if not hasattr(ts, "GATHER_SHARE"):
        return [("full", None)]
    return [("gather", 1.0), ("full", 0.0), ("rule", None)]


def taken(prof: dict) -> str | None:
    """The route a call's chunks took ("gather", "full", or both joined by
    "+"), from its profile; None for a tree without routes."""
    routes = prof.get("route")
    return None if routes is None else "+".join(r for r, n in routes.items() if n)


@contextlib.contextmanager
def gather_share(share_setting):
    """Inside, ``ops.search.GATHER_SHARE`` is ``share_setting`` (unless
    None): 0 sends every host chunk and streamed mesh group by the full
    route."""
    real = getattr(ts, "GATHER_SHARE", None)
    if share_setting is not None:
        ts.GATHER_SHARE = share_setting
    try:
        yield
    finally:
        if share_setting is not None:
            ts.GATHER_SHARE = real


def timed_call(paths, queries, device, share_setting, mesh=None) -> tuple[dict, float, dict]:
    """One search_files_device call (with ``mesh``, one sharded_search_files
    call on it) with ``GATHER_SHARE`` set (unless None): (results, wall
    seconds, profile)."""
    prof: dict = {}
    if mesh is None:
        def search():
            return ts.search_files_device(paths, queries, THRESHOLD, device, profile=prof)
    else:
        from ..parallel.sharded_search import sharded_search_files

        def search():
            return sharded_search_files(mesh, paths, queries, THRESHOLD, profile=prof)
    with gather_share(share_setting):
        t0 = time.perf_counter()
        res = search()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return res, time.perf_counter() - t0, prof


def canon(res: dict) -> dict:
    return {q: [(m.num_kmers_found, m.num_query_kmer, m.subject_info.run_accession)
                for m in hits] for q, hits in res.items() if hits}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", help="where the corpus is made or found (kept)")
    ap.add_argument("--log2-len", type=int, default=22)
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--shares", default="0.023,0.1,0.25,0.5")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--host", action="store_true",
                    help="hold the first share's hit lists to the host engine")
    ap.add_argument("--mesh", type=int, default=0,
                    help="also time the one-shot mesh search on N logical shards of the card")
    ap.add_argument("--out", help="the lines as one JSON list (default: the temporary "
                                  "directory's search_routes.json)")
    args = ap.parse_args(argv)
    device = bench_device()
    log = phase_log(device)
    mesh = None
    if args.mesh:
        from ..parallel.mesh import make_search_mesh

        mesh = make_search_mesh(1, args.mesh, [device] * args.mesh)
    log.log("h2d", bytes=H2D_BYTES, rates=h2d_rates(device))
    work = args.work or tempfile.mkdtemp(prefix="kwage_routes_")
    os.makedirs(work, exist_ok=True)
    try:
        t0 = time.perf_counter()
        paths = make_corpus(work, args.log2_len, args.files)
        log.log("corpus", files=len(paths), bytes_each=os.path.getsize(paths[0]),
                dt_sec=time.perf_counter() - t0)
        # The kernels, built and loaded, on a tiny matrix.
        db = torch.zeros((4, 1), dtype=torch.int32, device=device)
        ts.search_counts(db, torch.zeros((1, 1, 1), dtype=torch.int32, device=device),
                         torch.ones((1, 1), dtype=torch.bool, device=device))
        for si, share in enumerate(float(s) for s in args.shares.split(",")):
            queries, rows = batch_for_share(share, args.log2_len, si)
            want = None
            if args.host and si == 0:
                t0 = time.perf_counter()
                want = canon(search_database_files(paths, queries, THRESHOLD))
                log.log("host", share_target=share, queries=len(queries),
                        wall_s=time.perf_counter() - t0)
            for call in range(args.calls):
                for route, setting in routes_of_tree():
                    res, wall, prof = timed_call(paths, queries, device, setting)
                    got = canon(res)
                    if want is None:
                        want = got
                    check(got == want, f"share {share}: the {route} route's hit lists differ")
                    log.log("call", share_target=share, queries=len(queries), rows=rows,
                            share=rows / (1 << args.log2_len), route=route, taken=taken(prof),
                            call=call, wall_s=wall, hits=sum(map(len, got.values())),
                            steps=prof)
                    if mesh is None:
                        continue
                    res, wall, prof = timed_call(paths, queries, device, setting, mesh)
                    got = canon(res)
                    check(got == want, f"share {share}: the mesh's {route} route's hit lists "
                                       f"differ")
                    log.log("mesh_call", share_target=share, queries=len(queries), rows=rows,
                            share=rows / (1 << args.log2_len), route=route, call=call,
                            taken=taken(prof), mesh=args.mesh, wall_s=wall,
                            hits=sum(map(len, got.values())), steps=prof)
    finally:
        if not args.work:
            shutil.rmtree(work, ignore_errors=True)
    log.save(out_path(args.out, "search_routes"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
