"""The device ingest with the host out of the reading: the port's
counterpart of ``tools/bench_ingest.py``.

    python3 -m kwage_tpu_torch.bench.ingest [--out PATH]

Mbp/s through the whole counting chain on the card: canonical k-mers of
ASCII reads (``canonical_kmers``), the sort by (accession, word) and the
run selection (``count_multi_core``: ``radix_sort_pairs``, ``select_runs``),
then the filter bits of every accession in one pass (``bloom_set_bits``):
the chain behind ``build_blooms_device_batch``, the counterparts of
``kwage_tpu/ops/counting.py`` ``count_kmers_device_multi`` (:165) and
``set_filter_bits_multi`` (:257). No ``torch.sort`` or ``unique`` runs.

Workload (the JAX tool's; env INGEST_ACCS 8, INGEST_READS 8192 an
accession, INGEST_LEN 384, INGEST_COV 4, INGEST_MINCOUNT 2, INGEST_HASH 5,
INGEST_LOG2L 20; k = 31): reads sampled at COV x coverage from a random
genome an accession, made on the card from an explicit ``torch.Generator``
(25 Mbp a batch). The floor is the worst case the JAX tool's docstring
names: uniformly random reads at min count 1, so every window is selected
and scattered.

Each case is first checked: its number of selected words and its filter
image of accession 0 equal the exact count of those reads on the host
(numpy). Then the chain runs N times in a row, the reads rolled by i rows
in iteration i (the JAX tool's ``jnp.roll``), between two CUDA events;
the sort copies its kept count to the host each time, so no CUDA graph
can hold the chain. ms a batch is the slope between N = 1 and N = 5, the
median of 3. One JSON line a case, with the card's name and power limit,
then the JAX tool's result line (metric, value, unit, ms_per_batch) with
the floor beside it.

Runs on the card (exits 1 without one, unless ``KWAGE_TORCH_DEVICE=cpu``:
the plain versions, host clock, for the tests).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..native import canonical_kmers_native, murmur32_native
from ..ops.counting import bloom_set_bits, count_multi_core
from ..ops.kmers import canonical_kmers
from ._common import bench_device, check, out_arg, out_path, phase_log

ACCS = int(os.environ.get("INGEST_ACCS", "8"))
READS = int(os.environ.get("INGEST_READS", "8192"))
RLEN = int(os.environ.get("INGEST_LEN", "384"))
COV = int(os.environ.get("INGEST_COV", "4"))
MINCOUNT = int(os.environ.get("INGEST_MINCOUNT", "2"))
NH = int(os.environ.get("INGEST_HASH", "5"))
LOG2L = int(os.environ.get("INGEST_LOG2L", "20"))
K = 31
N_LO, N_HI, REPEATS = 1, 5, 3


def make_reads(device: torch.device, accs: int = ACCS, reads: int = READS, rlen: int = RLEN,
               cov: int = COV, unique: bool = False, seed: int = 0) -> torch.Tensor:
    """ASCII reads uint8 [accs * reads, rlen] on ``device``, accession by
    accession: sampled at ``cov`` x coverage from one random genome of
    reads * rlen / cov bases an accession, or (``unique``) uniformly random."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=device)
    if unique:
        return bases[torch.randint(0, 4, (accs * reads, rlen), generator=gen, device=device)]
    glen = reads * rlen // cov
    genomes = bases[torch.randint(0, 4, (accs * glen,), generator=gen, device=device)]
    starts = torch.randint(0, glen - rlen, (accs, reads), generator=gen, device=device)
    base = torch.arange(accs, device=device)[:, None, None] * glen
    pos = base + starts[:, :, None] + torch.arange(rlen, device=device)
    return genomes[pos].reshape(accs * reads, rlen)


def accession_ids(accs: int, reads: int, device: torch.device) -> torch.Tensor:
    return torch.arange(accs, dtype=torch.int32, device=device).repeat_interleave(reads)


def slots(accs: int, device: torch.device) -> torch.Tensor:
    """slot_of_acc: accession a -> image a; the invalid windows' id -> -1."""
    slot = torch.arange(accs + 1, dtype=torch.int32, device=device)
    slot[accs] = -1
    return slot


def chain(reads, acc_ids, slot, accs, k, min_count, nh, log2l):
    """The counting chain over one batch: (filter images int32 [accs,
    2^log2l / 32], selected words an accession int32 [accs])."""
    words, valid = canonical_kmers(reads, k)
    acc_s, words_s, selected, num_valid = count_multi_core(words, valid, acc_ids, min_count,
                                                           accs, k)
    return bloom_set_bits(acc_s, words_s, selected, slot, k, nh, log2l), num_valid


def host_truth(reads: np.ndarray, k: int, min_count: int, nh: int, log2l: int):
    """One accession's reads (ASCII [n, rlen]) counted exactly on the host:
    (selected words, packed image int32 [2^log2l / 32])."""
    joined = np.concatenate([reads, np.full((reads.shape[0], 1), ord("N"), np.uint8)], axis=1)
    uniq, counts = np.unique(canonical_kmers_native(joined.tobytes(), k), return_counts=True)
    kept = uniq[counts >= min_count]
    image = np.zeros(1 << log2l, bool)
    image[(murmur32_native(kept, k, nh) & np.uint32((1 << log2l) - 1)).reshape(-1)] = True
    return kept.size, np.packbits(image, bitorder="little").view(np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ms_per_batch(reads, acc_ids, slot, min_count: int) -> float:
    """The slope of the chained chain's time between N_LO and N_HI
    iterations (CUDA events on a card, the host clock on the CPU), the
    median of REPEATS."""
    device = reads.device

    def run(n: int) -> float:
        acc = torch.zeros((), dtype=torch.int64, device=device)
        _sync(device)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(n):
            images, nv = chain(torch.roll(reads, i, 0), acc_ids, slot, ACCS, K, min_count, NH,
                               LOG2L)
            acc += images[0, 0] + nv[0]
        if device.type == "cuda":
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        int(acc)
        return (time.perf_counter() - t0) * 1e3

    run(1)   # warm: the allocator's first blocks
    slopes = sorted((run(N_HI) - run(N_LO)) / (N_HI - N_LO) for _ in range(REPEATS))
    return slopes[len(slopes) // 2]


def main(argv: list[str] | None = None) -> int:
    args = out_arg(__doc__, argv)
    device = bench_device()
    log = phase_log(device)
    acc_ids, slot = accession_ids(ACCS, READS, device), slots(ACCS, device)
    total_bp = ACCS * READS * RLEN
    cases = {}
    for name, unique, min_count in (("representative", False, MINCOUNT),
                                    ("floor_unique_min1", True, 1)):
        reads = make_reads(device, ACCS, READS, RLEN, COV, unique=unique)
        images, nv = chain(reads, acc_ids, slot, ACCS, K, min_count, NH, LOG2L)
        n0, image0 = host_truth(reads[:READS].cpu().numpy(), K, min_count, NH, LOG2L)
        check(int(nv[0]) == n0 and np.array_equal(images[0].cpu().numpy(), image0),
              f"{name}: accession 0's selected words or image differ from the host count")
        ms = ms_per_batch(reads, acc_ids, slot, min_count)
        cases[name] = {"mbp_per_sec": total_bp / (ms * 1e-3) / 1e6, "ms_per_batch": ms,
                       "min_count": min_count, "selected_words": nv.sum().item()}
        log.log(name, **cases[name], batch_mbp=total_bp / 1e6, equal_to_host_count=True)
        del reads, images, nv
    rep, floor = cases["representative"], cases["floor_unique_min1"]
    where = "on the card" if device.type == "cuda" else "CPU, plain versions (not a device figure)"
    out = {
        "metric": "device_ingest_mbp_per_sec",
        "value": rep["mbp_per_sec"],
        "unit": (f"Mbp/s {where} (count+threshold+{NH}-seed scatter, {ACCS} accs batched, "
                 f"{COV}x coverage, min_count={MINCOUNT}, L=2^{LOG2L})"),
        "ms_per_batch": rep["ms_per_batch"],
        "floor": {"case": "uniformly random reads, min_count=1",
                  "mbp_per_sec": floor["mbp_per_sec"], "ms_per_batch": floor["ms_per_batch"]},
        "launches": {k: n for k, n in kernels.launch_counts().items() if n},
        "card": log.stamp["card"],
    }
    log.results.append(out)
    log.save(out_path(args.out, "ingest"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
