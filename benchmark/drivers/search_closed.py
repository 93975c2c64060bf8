"""Closed-loop clients against the port's resident search server.

Set-up: the configuration's corpus is built on the device and written as
.db files (``corpus``); the port's ``SearchServer`` (engine "device", one
card) loads them and listens on a loopback port; ``benchmark.clients``
starts in a process of its own, connects ``clients`` connections and sends
the mix's warm-up requests. The window: each client sends a request, waits
for its whole reply and sends the next, for ``seconds``. Then the server
is shut down and its device memory freed, and the plain search
(``reference.search``) answers a sample of the window's requests, drawn
from the seed; every hit list of them (run, k-mers found, k-mers of the
query) must equal the reply's.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys

import numpy as np
import torch

from .. import corpus, manifest, sequences, work

TIMEOUT_S = 120


def _read_line(child: subprocess.Popen, what: str) -> str:
    line = child.stdout.readline()
    if not line:
        raise RuntimeError(f"the client process ended before {what} "
                           f"(exit {child.wait(TIMEOUT_S)})")
    return line


def run(ctx) -> dict:
    cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
    paths = corpus.build(cfg, seed, ctx.workdir, device)
    ctx.phase("corpus")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    from kwage_tpu_torch.search.resident import SearchServer

    server = SearchServer(paths, engine="device", device=device)
    server.start()
    ctx.phase("server_load")
    spec = {"host": server.address[0], "port": server.address[1], "config": ctx.cell["config"],
            "traffic": ctx.cell["traffic"], "seed": seed, "seconds": ctx.seconds,
            "sample": mix["sample_requests"], "timeout_s": TIMEOUT_S, "root": ctx.root}
    child = subprocess.Popen([sys.executable, "-m", "benchmark.clients", json.dumps(spec)],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                             cwd=str(manifest.HERE.parent))
    ctx.children.append(child)
    try:
        line = _read_line(child, "its warm-up").strip()
        if line != "ready":
            raise RuntimeError(f"the client process did not report ready: {line}")
        ctx.phase("warmup")
        ctx.open_window()
        child.stdin.write("go\n")
        child.stdin.flush()
        report = json.loads(_read_line(child, "the end of the window"))
        ctx.close_window()
        child.wait(TIMEOUT_S)
    finally:
        server.shutdown()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    records = report["records"]
    ok = [r for r in records if r[4]]
    lat_ms = np.array([(r[2] - r[1]) * 1e3 for r in ok])
    done_bases = sum(r[3] for r in ok if r[2] <= ctx.seconds)

    def third_bases(i: int) -> int:
        lo, hi = i * ctx.seconds / 3, (i + 1) * ctx.seconds / 3
        return sum(r[3] for r in ok if lo < r[2] <= hi)

    genomes = sequences.genomes(cfg, seed)
    ctx.phase("teardown")
    ref = corpus.reference(cfg, paths, device)
    mismatched = compared = hits = 0
    for j, got in report["sample"].items():
        queries = sequences.request(mix, genomes, seed, int(j))
        want = ref.answer(queries, mix["threshold"])
        got = {int(i): [tuple(h) for h in v] for i, v in (got or {}).items()}
        compared += len(queries)
        hits += sum(map(len, want.values()))
        mismatched += sum(want.get(i) != got.get(i) for i in range(len(queries)))
    out = {
        "end_to_end": {
            "search_kbp_per_s": done_bases / ctx.seconds / 1e3,
            "search_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else float("inf"),
        },
        "attempted": len(records),
        "failed": len(records) - len(ok),
        "checks": {
            "mismatched_queries": {"value": mismatched, "limit": 0},
            "failed_requests": {"value": len(records) - len(ok), "limit": 0},
            "compared_queries": {"value": compared, "min": 1},
            "compared_hits": {"value": hits, "min": 1},
        },
        "errors": report["errors"],
        # The rate in each third of the window: a trend here is warm-up or
        # decay inside the window, not noise between runs.
        "thirds_kbp_per_s": [third_bases(i) / (ctx.seconds / 3) / 1e3 for i in range(3)],
        "memory_peak_bytes": memory_peak,
        "work": {},
    }
    if ctx.trace:
        queries = [q for r in records for q in sequences.request(mix, genomes, seed, r[0])]
        words = len(paths) * cfg["filters_per_file"] // 32
        nk = work.distinct_kmers(queries, cfg["k"], device)
        out["work"]["search_bytes"] = sum(
            work.search_bytes(n, cfg["num_hash"], words, mix["threshold"]) for n in nk)
    del ref
    ctx.phase("check")
    return out
