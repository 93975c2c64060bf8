"""Search throughput on the card: the port's counterpart of ``bench.py``.

    python3 -m kwage_tpu_torch.bench.search

Workload (``bench.py``'s; env BENCH_LOG2_L, BENCH_FILES, BENCH_NQ,
BENCH_NK): a 2^22-row signature matrix 8 database files of 2048 filters
wide (W = 64 x files int32 words, 8 GiB), made on the device from a seeded
generator; 8 queries of 1024 valid k-mers, 5 hash seeds, the slice indices
from numpy's ``default_rng(0)``. One "k-mer query" is one k-mer's 5
slice-row probes, their AND and its hit count over ONE 2048-filter file, so
a call does nq x nk x files of them.

First the public wrappers ``search_counts`` and ``search_complete`` must
equal ``counts_ref`` and ``complete_ref`` on the device, bit for bit; their
wall a call (host clock, with the wrapper's host read of idx's range) is
printed. Then each kernel is timed with CUDA events over a CUDA graph of
raw launches that cycles a ring of RING index tensors (idx + i) & (2^L - 1),
so no two consecutive launches gather the same rows (one launch gathers
84 MB at the default, the L2 holds 50 MB): SAMPLES samples, each the median
of REPLAYS graph replays. Each sample's effective bytes/s (nq x nk x nh x W
x 4 gathered bytes a call over its time) and share of the card's memory
rate are printed; a sample above 1.05 x that rate cannot have happened and
is rejected, and the run fails when fewer than 3 are left.

``vs_baseline`` is ``bench.py``'s host pass in the same run: numpy on one
core, a 2^19 x 64 matrix, 256 k-mers, median of 5.

The last line has ``bench.py``'s keys: metric, value, unit, vs_baseline,
complete_match_kmer_queries_per_sec, spread. The device, the wrappers'
walls, the ceiling and every sample go on earlier lines. With
``KWAGE_TORCH_DEVICE=cpu`` the plain versions run on the CPU, timed by the
host clock (the tests); the unit then says so.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..kernels.time_kernel import HBM_BYTES_PER_S, cuda_ms
from ..ops.search import complete_ref, counts_ref, search_complete, search_counts
from ._common import bench_device, check, hold_to_ceiling, median_spread, print_device

LOG2_L = int(os.environ.get("BENCH_LOG2_L", "22"))
FILES = int(os.environ.get("BENCH_FILES", "8"))  # same-shape files fused
NQ = int(os.environ.get("BENCH_NQ", "8"))
NK = int(os.environ.get("BENCH_NK", "1024"))
NH = 5
RING = 8          # perturbed index tensors the timed launches cycle
SAMPLES = 5
REPLAYS = 5       # graph replays a sample takes the median of
WRAPPER_CALLS = 20


def make_workload(device: torch.device, log2_l: int = LOG2_L, files: int = FILES,
                  nq: int = NQ, nk: int = NK, seed: int = 0):
    """(db int32 [2^log2_l, 64 x files] on ``device``, idx int32 [nq, nk,
    NH] and valid bool [nq, nk] as numpy arrays, the numpy generator that
    drew idx): ``bench.py``'s workload, the matrix drawn on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    db = torch.empty((1 << log2_l, 64 * files), dtype=torch.int32, device=device).random_(
        -2**31, 2**31, generator=gen)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << log2_l, size=(nq, nk, NH), dtype=np.int32)
    return db, idx, np.ones((nq, nk), dtype=bool), rng


def gathered_bytes(n_valid_kmers: int, nh: int, words: int) -> int:
    """Bytes one search call must gather: nh slice rows of W int32 words for
    each valid k-mer."""
    return n_valid_kmers * nh * words * 4


def host_baseline(rng: np.random.Generator, idx: np.ndarray) -> float:
    """``bench.py``'s host pass: k-mer queries/s of numpy on one core over
    one 2048-filter file, a 2^19-row matrix (past the L3, so the gather is
    memory-bound as the full one would be), 256 k-mers, median of 5."""
    h_log2, hw = min(19, LOG2_L), 64
    hk = min(256, NK)
    db_host = rng.integers(0, 1 << 32, size=(1 << h_log2, hw), dtype=np.uint32)
    h_idx = idx[:1, :hk] & ((1 << h_log2) - 1)

    def cpu_pass() -> float:
        t0 = time.perf_counter()
        rows = db_host[h_idx.reshape(-1)].reshape(1, hk, NH, hw)
        km = rows[:, :, 0, :]
        for h in range(1, NH):
            km = km & rows[:, :, h, :]
        bits = np.unpackbits(km.view(np.uint8), axis=-1, bitorder="little")
        _ = bits.reshape(1, hk, -1).sum(axis=1)
        return time.perf_counter() - t0

    cpu_pass()  # warm-up: first-touch faults, allocator
    return hk / sorted(cpu_pass() for _ in range(5))[2]


def wrapper_ms(fn, db, idx, valid) -> float:
    """Wall ms of one public wrapper call, host clock over WRAPPER_CALLS
    calls ending in a synchronize (each call reads idx's range back)."""
    fn(db, idx, valid)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
    t0 = time.perf_counter()
    for _ in range(WRAPPER_CALLS):
        fn(db, idx, valid)
    if db.device.type == "cuda":
        torch.cuda.synchronize(db.device)
    return (time.perf_counter() - t0) * 1e3 / WRAPPER_CALLS


def kernel_samples(name: str, db, ring, valid, out) -> list[float]:
    """SAMPLES readings of ms a call: on a card, each the median of REPLAYS
    replays of a CUDA graph of raw ``name`` launches cycling ``ring``; on
    the CPU, the median of REPLAYS host-clock passes of the plain version
    over the ring."""
    nq, nk, nh = ring[0].shape
    if db.device.type == "cuda":
        turn = itertools.count()

        def call(stream):
            ix = ring[next(turn) % len(ring)]
            kernels.launch(name, db.data_ptr(), ix.data_ptr(), valid.data_ptr(),
                           out.data_ptr(), nq, nk, nh, db.shape[1], stream)

        with torch.cuda.device(db.device):
            return [statistics.median(cuda_ms(call, 1) for _ in range(REPLAYS))
                    for _ in range(SAMPLES)]
    plain = complete_ref if name == "search_complete" else counts_ref

    def one_pass() -> float:
        t0 = time.perf_counter()
        for ix in ring:
            plain(db, ix, valid)
        return (time.perf_counter() - t0) * 1e3 / len(ring)

    return [statistics.median(one_pass() for _ in range(REPLAYS)) for _ in range(SAMPLES)]


def main() -> int:
    device = bench_device()
    label = print_device(device)
    db, idx_np, valid_np, rng = make_workload(device)
    W = db.shape[1]
    idx = torch.from_numpy(idx_np).to(device)
    valid = torch.from_numpy(valid_np).to(device)
    n_valid = int(valid_np.sum())
    per_call = n_valid * FILES          # k-mer queries over one 2048-filter file
    nbytes = gathered_bytes(n_valid, NH, W)

    # The hand-written kernels, through the public wrappers, against their
    # plain versions on the same device.
    for name, fn, plain in (("search_counts", search_counts, counts_ref),
                            ("search_complete", search_complete, complete_ref)):
        check(torch.equal(fn(db, idx, valid), plain(db, idx, valid)),
              f"{name} differs from its plain version")
        print(json.dumps({"wrapper": name, "equal_to_plain": True,
                          "ms_per_call": wrapper_ms(fn, db, idx, valid),
                          "calls": WRAPPER_CALLS,
                          "note": "host clock, with the wrapper's host read of idx's range"}),
              flush=True)

    ceiling_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"ceiling": {"bytes_per_call": nbytes, "hbm_bytes_per_s": HBM_BYTES_PER_S,
                                  "ms_per_call": ceiling_ms,
                                  "kmer_queries_per_s": per_call / (ceiling_ms * 1e-3)}}),
          flush=True)

    mask = (1 << LOG2_L) - 1
    ring = [((idx + i) & mask).contiguous() for i in range(RING)]
    rates = {}
    for name, cols in (("search_counts", W * 32), ("search_complete", W)):
        out = torch.empty((NQ, cols), dtype=torch.int32, device=device)
        kept = hold_to_ceiling(name, kernel_samples(name, db, ring, valid, out), nbytes)
        rates[name] = sorted(per_call / (ms * 1e-3) for ms in kept)
    counted = kernels.launch_counts()
    print(json.dumps({"launches": {name: counted[name] for name in rates},
                      "note": "launches made: the wrappers' calls and the launches recorded "
                              "into graphs (each recorded launch runs once a replay)"}),
          flush=True)

    counts_rate = statistics.median(rates["search_counts"])
    cpu_rate = host_baseline(rng, idx_np)
    where = "" if device.type == "cuda" else f"; {label}"
    print(json.dumps({
        "metric": "kmer_queries_per_sec_per_chip",
        "value": counts_rate,
        "unit": f"kmer-queries/s (2048-filter files, {NH} seeds, 2^{LOG2_L} rows, "
                f"{FILES} files fused{where})",
        "vs_baseline": counts_rate / cpu_rate,
        "complete_match_kmer_queries_per_sec": statistics.median(rates["search_complete"]),
        "spread": median_spread(rates["search_counts"]),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
