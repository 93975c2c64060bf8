"""Weak scaling of the search over the mesh's "filters" axis: the port's
counterpart of ``bench_scaling.py``.

    python3 -m kwage_tpu_torch.bench.scaling [--out PATH]

Each mesh slot holds one column shard of 2^20 rows x 512 words (8 fused
2048-filter files, 2 GiB), drawn on its device, so the corpus grows with
the mesh and perfect scaling is a flat time a step. The mesh
(``parallel.mesh.make_search_mesh``: 1 x nd) takes nd = 1, 2, 4, ... up to
``torch.cuda.device_count()`` cards. Where one device is visible (one
card, or the CPU), the points above 1 run on 8 logical slots of it, the counterpart of the JAX tool's virtual CPU mesh: they are
labelled ``"logical": true`` and claim no efficiency (their slots share
the card's memory and SMs).

Per point: ``search_counts`` over 8 queries x 512 k-mers, 5 seeds (numpy
``default_rng(0)``), on every slot. First the mesh path
(``parallel.sharded_search.sharded_search_counts``, read back by
``to_host``) must equal the one-device run, ``search_counts`` over the
whole matrix on one device. Then each device replays a CUDA graph of its
slots' raw launches, GRAPH_LAUNCHES steps cycling RING index tensors (idx
+ i) & (2^L - 1), all devices at once between CUDA events; a step's ms is
the slowest device's, the median of SAMPLES. k-mer queries/s count the
2048-filter file equivalents (NQ x NK x nd x W/64 a step, the JAX tool's); the
efficiency is the rate over nd x the one-slot rate (SCALING_BASE_RATE
sets that rate for a run with no one-slot point).

Several processes (KWAGE_COORDINATOR_ADDRESS, KWAGE_NUM_PROCESSES,
KWAGE_PROCESS_ID; ``parallel.distributed``): the one point measured is
the global mesh over every process's devices
(``make_global_search_mesh``), each process checks its own shards'
columns of the gathered result against ``search_counts`` on them, a step
is the slowest process's, and process 0 prints. Env SCALING_LOG2_L (20), SCALING_W_PER_DEV (512),
SCALING_NQ (8), SCALING_NK (512).

Runs on the card (exits 1 without one, unless ``KWAGE_TORCH_DEVICE=cpu``:
the plain versions, host clock, for the tests). One JSON line a point
with the card's name and power limit, then a ``done`` line with the
kernels' launches.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..kernels.time_kernel import GRAPH_LAUNCHES
from ..ops.search import counts_ref, search_counts
from ..parallel.distributed import init_distributed, make_global_search_mesh
from ..parallel.mesh import default_devices, make_search_mesh
from ..parallel.sharded_search import MeshMatrix, sharded_search_counts, to_host
from ._common import bench_device, check, out_arg, out_path, phase_log

LOG2_L = int(os.environ.get("SCALING_LOG2_L", "20"))
W_PER_DEV = int(os.environ.get("SCALING_W_PER_DEV", "512"))
NQ = int(os.environ.get("SCALING_NQ", "8"))
NK = int(os.environ.get("SCALING_NK", "512"))
LOGICAL = 8      # logical slots of a lone device (the JAX tool's 8 virtual CPUs)
NH = 5
RING = 8
SAMPLES = 5


def shard(f: int, device: torch.device) -> torch.Tensor:
    """Column shard f: int32 [2^L, W_PER_DEV] from a generator seeded f."""
    gen = torch.Generator(device=device)
    gen.manual_seed(f)
    return torch.empty((1 << LOG2_L, W_PER_DEV), dtype=torch.int32, device=device).random_(
        -2**31, 2**31, generator=gen)


def queries() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 1 << LOG2_L, size=(NQ, NK, NH), dtype=np.int32)
    return idx, np.ones((NQ, NK), dtype=bool)


def step_ms(mesh, shards: dict, idx: np.ndarray, valid: np.ndarray) -> float:
    """ms of one step (search_counts on every local slot): on cards, each
    device replays a CUDA graph of its slots' raw launches (GRAPH_LAUNCHES
    steps cycling RING index tensors) between CUDA events, all devices at
    once, and a step is the slowest device's; on the CPU the host clock
    over the plain version. The median of SAMPLES."""
    mask = (1 << LOG2_L) - 1
    slots = mesh.local_slots()
    devs = list(dict.fromkeys(mesh.devices[d, f] for d, f in slots))
    rings = {dev: [torch.from_numpy((idx + i) & mask).to(dev) for i in range(RING)]
             for dev in devs}
    valid_on = {dev: torch.from_numpy(valid).to(dev) for dev in devs}
    if devs[0].type != "cuda":
        def one_pass() -> float:
            t0 = time.perf_counter()
            for i in range(RING):
                for d, f in slots:
                    dev = mesh.devices[d, f]
                    counts_ref(shards[(dev, f)], rings[dev][i], valid_on[dev])
            return (time.perf_counter() - t0) * 1e3 / RING

        return statistics.median(one_pass() for _ in range(SAMPLES))
    outs = {(d, f): torch.empty((NQ, W_PER_DEV * 32), dtype=torch.int32,
                                device=mesh.devices[d, f]) for d, f in slots}
    graphs = {}
    for dev in devs:
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            graph = graphs[dev] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                for i in range(GRAPH_LAUNCHES):
                    ix = rings[dev][i % RING]
                    for d, f in slots:
                        if mesh.devices[d, f] == dev:
                            kernels.launch("search_counts", shards[(dev, f)].data_ptr(),
                                           ix.data_ptr(), valid_on[dev].data_ptr(),
                                           outs[(d, f)].data_ptr(), NQ, NK, NH, W_PER_DEV,
                                           side.cuda_stream)
            graph.replay()
    for dev in devs:
        torch.cuda.synchronize(dev)

    def sample() -> float:
        marks = {}
        for dev in devs:
            with torch.cuda.device(dev):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                graphs[dev].replay()
                end.record()
                marks[dev] = (start, end)
        for start, end in marks.values():
            end.synchronize()
        return max(s.elapsed_time(e) for s, e in marks.values()) / GRAPH_LAUNCHES

    return statistics.median(sample() for _ in range(SAMPLES))


def point(log, mesh, shards: dict, idx, valid, same, base_rate, logical: bool,
          slowest=lambda ms: ms) -> float:
    """One mesh size: the check (``same(global counts)``), the timing
    (``slowest`` combines the processes' readings) and its line (``log``
    None: another process prints); returns the rate."""
    nd = mesh.shape["filters"]
    got = to_host(sharded_search_counts(mesh, MeshMatrix(mesh, shards), idx, valid))
    check(same(got), f"{nd} slots: the mesh's counts differ from the one-device run")
    ms = slowest(step_ms(mesh, shards, idx, valid))
    rate = NQ * NK * nd * (W_PER_DEV / 64) / (ms * 1e-3)
    if logical:
        eff = None
    elif base_rate is None:
        eff = 1.0 if nd == 1 and not mesh.spans_processes else None
    else:
        eff = rate / (base_rate * nd)
    if log is not None:
        log.log("point", devices=nd, logical=logical, ms_per_step=ms,
                kmer_queries_per_sec=rate, scaling_efficiency=eff,
                counts_equal_one_device=True)
    return rate


def launches() -> dict:
    return {k: n for k, n in kernels.launch_counts().items() if n}


def main(argv: list[str] | None = None) -> int:
    args = out_arg(__doc__, argv)
    device = bench_device()
    multiproc = init_distributed()
    idx, valid = queries()
    base_rate = (float(os.environ["SCALING_BASE_RATE"])
                 if os.environ.get("SCALING_BASE_RATE") else None)
    if multiproc:
        import torch.distributed as dist

        log = phase_log(device) if dist.get_rank() == 0 else None
        mesh = make_global_search_mesh(num_data=1)
        shards = {(mesh.devices[d, f], f): shard(f, mesh.devices[d, f])
                  for d, f in mesh.local_slots()}
        W = W_PER_DEV * 32
        # The collectives' tensors: CUDA ones under NCCL, CPU ones under gloo.
        on = device if dist.get_backend() == "nccl" else torch.device("cpu")

        def own_columns(got) -> bool:
            """This process's shards' columns of the gathered counts equal
            search_counts on each shard alone, in every process."""
            ok = all(torch.equal(torch.from_numpy(got[:, f * W:(f + 1) * W]),
                                 search_counts(s, torch.from_numpy(idx).to(dev),
                                               torch.from_numpy(valid).to(dev)).cpu())
                     for (dev, f), s in shards.items())
            verdict = torch.tensor([int(ok)], device=on)
            dist.all_reduce(verdict, op=dist.ReduceOp.MIN)
            return bool(verdict.item())

        def slowest(ms: float) -> float:
            t = torch.tensor([ms], dtype=torch.float64, device=on)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return t.item()

        point(log, mesh, shards, idx, valid, own_columns, base_rate, False, slowest)
        if log is not None:
            log.log("done", points=[mesh.size], processes=dist.get_world_size(),
                    launches=launches())
            log.save(out_path(args.out, "scaling"))
        return 0

    log = phase_log(device)
    devices = default_devices()
    logical = len(devices) == 1
    pool = devices * LOGICAL if logical else devices
    sizes = [1 << i for i in range(len(pool).bit_length()) if 1 << i <= len(pool)]
    whole = torch.cat([shard(f, pool[0]) for f in range(sizes[-1])], dim=1)
    want = search_counts(whole, torch.from_numpy(idx).to(pool[0]),
                         torch.from_numpy(valid).to(pool[0])).cpu().numpy()
    del whole
    for nd in sizes:
        mesh = make_search_mesh(1, nd, pool[:nd])
        shards = {(pool[f], f): shard(f, pool[f]) for f in range(nd)}
        rate = point(log, mesh, shards, idx, valid,
                     lambda got, nd=nd: np.array_equal(got, want[:, :nd * W_PER_DEV * 32]),
                     base_rate, logical and nd > 1)
        if nd == 1 and base_rate is None:
            base_rate = rate
        del shards, mesh
        if device.type == "cuda":
            torch.cuda.empty_cache()
    log.log("done", points=sizes, logical=logical, launches=launches())
    log.save(out_path(args.out, "scaling"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
