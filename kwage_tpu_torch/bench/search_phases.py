"""The search call split into its phases on the card: the port's
counterpart of ``tools/bench_search_phases.py``.

    python3 -m kwage_tpu_torch.bench.search_phases [--out PATH]

Shape (the JAX tool's; env BENCH_LOG2_L, BENCH_NQ, BENCH_NK): a 2^22-row
signature matrix 8 fused 2048-filter files wide (W = 512 words, 8 GiB),
drawn on the device (``bench.search.make_workload``), NQ 8 queries of NK
1024 valid k-mers, 5 seeds. The phases, each one kernel:

  gather1      one seed's rows gathered and XOR-folded to one word
               (``gather1``, csrc/variants/search_phases.cu)
  gather5_and  five seeds gathered, ANDed, XOR-folded (``gather5_and``;
               the seed phase, _gather_and_reduce_seeds in kwage_tpu)
  complete     the production ``search_complete`` (+ the k-mer AND)
  counts       the production ``search_counts`` (+ the carry-save count)

The two gather kernels are search.cu's chunked kernels stopped before
their merge, so the deltas between the phases are the merges' cost; they
are built alone (``time_kernel.load``) and launched and counted here
(``launch``, ``launch_counts``). Each kernel is first held bit for bit
against its plain version on the same inputs (``max_abs_err``; the plain
version's ms by CUDA events, ``plain_ms``). Then each is timed as
``bench.search`` times its kernels: CUDA events over replays of a CUDA
graph of raw launches that cycles RING index tensors (idx + i) &
(2^L - 1), the counterpart of the JAX tool's chained ``fori_loop`` over
perturbed indices; SAMPLES samples, each the median of REPLAYS replays;
ms_per_iter is their median. gather_gb_per_s counts the rows a phase
gathers (NQ x NK for gather1, x 5 for the others) at 2 KiB;
``attribution_ms`` has the JAX tool's deltas; ``launches`` counts the
timed launches, not the checks'. ``caveats`` says whether
gather1 read faster than the card's 3.35 TB/s, which would make it no
bandwidth figure.

Runs on the card (``KWAGE_TORCH_DEVICE``, default ``cuda``; exits 1
without one); ``KWAGE_TORCH_DEVICE=cpu`` runs the plain versions, timed by
the host clock (the tests). One JSON line a phase, each with the card's
name and power limit, then the JAX tool's result object; the lines go to
``--out`` as one list (default: search_phases.json in the temporary
directory). Exits 1 when a kernel differs from its plain version.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import statistics
import sys
import threading
import time

import torch

from .. import kernels
from ..kernels.time_kernel import HBM_BYTES_PER_S, cuda_ms, load
from ..ops.search import (_launch_search, _seed_and, complete_ref, counts_ref, search_complete,
                          search_counts)
from ._common import bench_device, check, out_arg, out_path, phase_log
from .search import make_workload

LOG2_L = int(os.environ.get("BENCH_LOG2_L", "22"))
FILES = 8
NQ = int(os.environ.get("BENCH_NQ", "8"))
NK = int(os.environ.get("BENCH_NK", "1024"))
NH = 5
RING = 8
SAMPLES = 5
REPLAYS = 5


# --- the two gather kernels and their plain versions ---------------------------------

SOURCE = os.path.join(kernels.CSRC_DIR, "variants", "search_phases.cu")
ENTRIES = ("gather1", "gather5_and")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LAUNCHES = dict.fromkeys(ENTRIES, 0)


def get_lib() -> ctypes.CDLL:
    """SOURCE built alone (``time_kernel.load``) and bound, at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = load(SOURCE, ENTRIES)
            lib.kw_error_string.argtypes = [ctypes.c_int]
            lib.kw_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def launch(name: str, *args) -> None:
    """Launch ``gather1`` or ``gather5_and`` (search_complete's arguments);
    raise on a CUDA error, else count the launch."""
    lib = get_lib()
    err = getattr(lib, "kw_" + name)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.kw_error_string(err).decode()})")
    with _LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    with _LOCK:
        return dict(_LAUNCHES)

def xor_fold(x: torch.Tensor) -> torch.Tensor:
    """int32 [1]: the XOR of every element of ``x`` (a pairwise tree; torch
    has no XOR reduction)."""
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(1, dtype=torch.int32, device=x.device)
    while flat.numel() > 1:
        half = flat.numel() // 2
        folded = flat[:half] ^ flat[half:2 * half]
        flat = torch.cat([folded, flat[2 * half:]]) if flat.numel() % 2 else folded
    return flat.clone()


def _valid_words(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    km = _seed_and(db, idx)
    return torch.where(valid[:, :, None], km, torch.zeros_like(km))


def gather1_ref(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain gather1: int32 [1], the XOR of every word of seed 0's row of
    every valid k-mer."""
    return xor_fold(_valid_words(db, idx[:, :, :1], valid))


def gather5_and_ref(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain gather5_and: int32 [1], the XOR of every word of the AND of the
    nh seeds' rows of every valid k-mer."""
    return xor_fold(_valid_words(db, idx, valid))


def _fold(name: str, plain, db, idx, valid) -> torch.Tensor:
    if db.device.type == "cpu":
        return plain(db, idx, valid)
    return _launch_search(name, db, idx, valid,
                          torch.zeros(1, dtype=torch.int32, device=db.device), launch=launch)


def gather1(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """CUDA tensors: the gather1 kernel; CPU tensors: gather1_ref."""
    return _fold("gather1", gather1_ref, db, idx, valid)


def gather5_and(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """CUDA tensors: the gather5_and kernel; CPU tensors: gather5_and_ref."""
    return _fold("gather5_and", gather5_and_ref, db, idx, valid)


# phase -> (its kernel's C entry, its launcher, wrapper, plain version,
# output int32 words a query for W words; 0: one word in all)
PHASES = {
    "gather1": ("gather1", launch, gather1, gather1_ref, lambda W: 0),
    "gather5_and": ("gather5_and", launch, gather5_and, gather5_and_ref, lambda W: 0),
    "complete": ("search_complete", kernels.launch, search_complete, complete_ref, lambda W: W),
    "counts": ("search_counts", kernels.launch, search_counts, counts_ref, lambda W: W * 32),
}


def phase_samples(name: str, db: torch.Tensor, ring: list, valid: torch.Tensor) -> list[float]:
    """SAMPLES readings of ms a call of phase ``name``: on a card each the
    median of REPLAYS replays of a CUDA graph of raw launches cycling
    ``ring``; on the CPU the median of REPLAYS host-clock passes of the
    plain version over the ring."""
    nq, nk, nh = ring[0].shape
    W = db.shape[1]
    entry, launcher, _, plain, cols_of = PHASES[name]
    cols = cols_of(W)
    if db.device.type != "cuda":

        def one_pass() -> float:
            t0 = time.perf_counter()
            for ix in ring:
                plain(db, ix, valid)
            return (time.perf_counter() - t0) * 1e3 / len(ring)

        return [statistics.median(one_pass() for _ in range(REPLAYS)) for _ in range(SAMPLES)]
    out = torch.empty((nq, cols) if cols else (1,), dtype=torch.int32, device=db.device)
    turn = itertools.count()

    def call(stream):
        ix = ring[next(turn) % len(ring)]
        launcher(entry, db.data_ptr(), ix.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), nq, nk, nh, W, stream)

    with torch.cuda.device(db.device):
        return [statistics.median(cuda_ms(call, 1) for _ in range(REPLAYS))
                for _ in range(SAMPLES)]


def plain_ms(plain, db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> float | None:
    """ms of one call of a plain version on the card (CUDA events over 3
    calls after one); None off a card."""
    if db.device.type != "cuda":
        return None

    def call(stream):
        plain(db, idx, valid)

    with torch.cuda.device(db.device):
        return cuda_ms(call, 3, graph=False)


def main(argv: list[str] | None = None) -> int:
    args = out_arg(__doc__, argv)
    device = bench_device()
    log = phase_log(device)
    db, idx_np, valid_np, _ = make_workload(device, LOG2_L, FILES, NQ, NK)
    W = db.shape[1]
    idx = torch.from_numpy(idx_np).to(device)
    valid = torch.from_numpy(valid_np).to(device)
    checked = {}
    for name, (_, _, fn, plain, _) in PHASES.items():
        got, want = fn(db, idx, valid), plain(db, idx, valid)
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"{name} differs from its plain version")
        checked[name] = {"max_abs_err": err, "plain_ms": plain_ms(plain, db, idx, valid)}
    log.log("check", kernels_equal_plain=list(PHASES))
    at_check = {**kernels.launch_counts(), **launch_counts()}

    mask = (1 << LOG2_L) - 1
    ring = [((idx + i) & mask).contiguous() for i in range(RING)]
    n_valid = int(valid_np.sum())
    phases = {}
    for name in PHASES:
        rows = n_valid * (1 if name == "gather1" else NH)
        samples = phase_samples(name, db, ring, valid)
        ms = statistics.median(samples)
        phases[name] = {"ms_per_iter": ms, "gather_gb_per_s": rows * W * 4 / ms / 1e6,
                        "kmer_queries_per_s": n_valid * FILES / (ms * 1e-3), **checked[name]}
        if name in ENTRIES:
            # Their bound's terms: the rows gathered, idx, valid and the
            # output word; one XOR (or AND) a gathered word.
            phases[name].update(bytes=rows * W * 4 + idx.numel() * 4 + valid.numel() + 4,
                                operations=rows * W)
        log.log(name, samples_ms=samples, **phases[name],
                share_of_hbm=rows * W * 4 / (ms * 1e-3) / HBM_BYTES_PER_S)
    # The timed launches, the checks' left out.
    now = {**kernels.launch_counts(), **launch_counts()}
    launches = {PHASES[name][0]: now[PHASES[name][0]] - at_check[PHASES[name][0]]
                for name in PHASES}

    t1, t5 = phases["gather1"]["ms_per_iter"], phases["gather5_and"]["ms_per_iter"]
    tc, tn = phases["complete"]["ms_per_iter"], phases["counts"]["ms_per_iter"]
    g1_rate = phases["gather1"]["gather_gb_per_s"] * 1e9
    over = device.type == "cuda" and g1_rate > HBM_BYTES_PER_S
    caveats = [
        (f"gather1 read {g1_rate / 1e12:.4g} TB/s, above the card's "
         f"{HBM_BYTES_PER_S / 1e12:.4g} TB/s: NOT a bandwidth measure (rows it gathers "
         "stay in the 50 MB L2 or repeat); do not derive per-seed cost from it."
         if over else
         f"gather1 read {g1_rate / 1e12:.4g} TB/s, under the card's "
         f"{HBM_BYTES_PER_S / 1e12:.4g} TB/s." if device.type == "cuda" else
         "CPU run: the plain versions timed by the host clock; no device figure."),
        "Launches in a CUDA graph on one stream run in order: unlike the JAX tool's "
        "fori_loop, no iteration overlaps the next, so gather1 is a serial reading too.",
        "complete and counts are the production kernels; each differs from gather5_and "
        "only in its merge (an AND into an all-ones output, or carry-save planes "
        "expanded into integer counts), so tc - t5 and tn - t5 are the merges' cost.",
    ]
    out = {
        "shape": {"log2_rows": LOG2_L, "row_bytes": W * 4, "files": FILES, "nq": NQ,
                  "nk": NK, "seeds": NH},
        "phases": phases,
        "attribution_ms": {
            "gather_per_seed": t1,
            "five_seeds_expected": NH * t1,
            "five_seeds_actual": t5,
            "seed_and_overhead": t5 - NH * t1,
            "kmer_tree_and": tc - t5,
            "csa_popcount": tn - t5,
        },
        "caveats": caveats,
        "gather1_above_hbm_rate": over,
        "launches": launches,
        "card": log.stamp["card"],
    }
    log.results.append(out)
    log.save(out_path(args.out, "search_phases"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
