"""Does row order pay on the card's gather? The port's counterpart of
``tools/exp_sorted_gather.py``.

    python3 -m kwage_tpu_torch.bench.sorted_gather [--out PATH]

The same index multiset in three orders, gathered from a [2^18, 512]
uint32 matrix (2 KiB rows, the production fused width; 512 MiB, drawn on
the device): N = 2^16 slice rows a pass (128 MiB, past the H100's 50 MB
L2), from numpy's ``default_rng(1)``:

  random       the baseline (what ``make_query_batch`` produces)
  sorted       fully ascending (the most row-run locality)
  blocked1024  sorted within blocks of 1024 (what a per-batch sort on the
               card could give)

Each order is gathered by the ``gather1`` kernel (csrc/variants/
search_phases.cu; one query of N k-mers, one seed), held first against
its plain version, and timed as ``bench.search_phases`` times it: CUDA
events over replays of a CUDA graph of launches cycling RING index
tensors (idx + i) & (2^18 - 1), which keep the order but for one wrap
point (the JAX tool's perturbation). Prints one JSON line an order (ms,
GB/s, share of the card's 3.35 TB/s, the card's name and power limit),
then the JAX tool's result object (``gbps`` by order, ``sorted_vs_random``,
and ``blocked_vs_random``). Whether order pays on the H100's L2 is the
card's own question: a later search PR needs the answer.

Runs on the card (exits 1 without one, unless ``KWAGE_TORCH_DEVICE=cpu``:
the plain version, host clock, for the tests). Like the JAX tool's, its
shape has no knob.
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from ..kernels.time_kernel import HBM_BYTES_PER_S
from ._common import bench_device, check, out_arg, out_path, phase_log
from .search_phases import gather1, gather1_ref, launch_counts, phase_samples

LOG2_L = 18
W = 512          # words a row: 2 KiB rows (the production fused width)
N = 1 << 16      # gathered rows a pass
BLOCK = 1024
RING = 8


def orders(log2_l: int = LOG2_L, n: int = N) -> dict[str, np.ndarray]:
    """The JAX tool's three orders of one index multiset (int32 [n])."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 1 << log2_l, size=n, dtype=np.int32)
    blocks = [np.sort(c) for c in base.reshape(-1, BLOCK)] if n % BLOCK == 0 else [np.sort(base)]
    return {"random": base, "sorted": np.sort(base), "blocked1024": np.concatenate(blocks)}


def main(argv: list[str] | None = None) -> int:
    args = out_arg(__doc__, argv)
    device = bench_device()
    log = phase_log(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    db = torch.empty((1 << LOG2_L, W), dtype=torch.int32, device=device).random_(
        -2**31, 2**31, generator=gen)
    valid = torch.ones((1, N), dtype=torch.bool, device=device)
    mask = (1 << LOG2_L) - 1
    bytes_per_pass = N * W * 4
    gbps, ms_of = {}, {}
    compared = 0   # the checks' launches, left out of the count
    for name, order in orders(LOG2_L, N).items():
        idx = torch.from_numpy(order.reshape(1, N, 1)).to(device)
        before = launch_counts()["gather1"]
        check(torch.equal(gather1(db, idx, valid), gather1_ref(db, idx, valid)),
              f"gather1 differs from its plain version on the {name} order")
        compared += launch_counts()["gather1"] - before
        ring = [((idx + i) & mask).contiguous() for i in range(RING)]
        samples = phase_samples("gather1", db, ring, valid)
        ms = statistics.median(samples)
        ms_of[name] = ms
        gbps[name] = bytes_per_pass / (ms * 1e-3) / 1e9
        log.log(name, samples_ms=samples, ms_per_pass=ms, gb_per_s=gbps[name],
                share_of_hbm=gbps[name] * 1e9 / HBM_BYTES_PER_S)
    out = {"shape": [1 << LOG2_L, W], "gathered_rows": N, "platform": device.type,
           "gbps": gbps, "ms_per_pass": ms_of,
           "sorted_vs_random": gbps["sorted"] / gbps["random"],
           "blocked_vs_random": gbps["blocked1024"] / gbps["random"],
           "launches": {"gather1": launch_counts()["gather1"] - compared},
           "card": log.stamp["card"]}
    log.results.append(out)
    log.save(out_path(args.out, "sorted_gather"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
