"""Where a batch of the device build spends its time: the port's
counterpart of ``tools/bench_build_phases.py``.

    python3 -m kwage_tpu_torch.bench.build_phases [--out PATH]

Workload (the JAX tool's; env PH_N_ACC 8, PH_BP 300000, PH_REPS 5): one
FASTA an accession of 300 bp reads at 4x coverage of a random genome
(numpy ``default_rng(0)``), built as one batch through the port's
``prepare_device_batch`` / ``dispatch_device_batch`` /
``finish_device_batch`` (``pipeline/make_bloom.py``) with min count 2 and
L 18-24, then each record written as a .bloom. A warm batch first, then
PH_REPS timed ones; per step the median and the least:

  prepare         host: scan and 2-bit pack (wall)
  dispatch        upload + canonical_kmers + sort + select_runs launched
                  (wall; the sort copies its kept count back, so it waits
                  for the count); ``dispatch_device_ms``: CUDA events
  count_readback  the per-accession counts to the host (wall)
  finish_rest     solve + bloom_set_bits + the images back + records
                  (wall; ``finish_device_ms``: CUDA events)
  bloom_write     the .bloom files (wall)
  total           the sum of the walls

Checks: every record built; each written .bloom equals the exact ground
truth of its reads (``bench._common.exact_bloom``). One JSON line a step,
with the card's name and power limit, then ``filters_per_sec_serial``.

Runs on the card (exits 1 without one, unless ``KWAGE_TORCH_DEVICE=cpu``:
the plain versions, for the tests).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from .. import kernels
from ..core import FilterInfo
from ..io.bloom_file import read_bloom_file, write_bloom_file
from ..pipeline.make_bloom import (
    BuildOptions,
    dispatch_device_batch,
    finish_device_batch,
    prepare_device_batch,
)
from ..scale._corpus import fasta_reads
from ._common import bench_device, check, exact_bloom, out_arg, out_path, phase_log

N = int(os.environ.get("PH_N_ACC", "8"))
BP = int(os.environ.get("PH_BP", "300000"))
REPS = int(os.environ.get("PH_REPS", "5"))
READ_LEN = 300
OPTS = dict(min_kmer_count=2, min_log_2_filter_len=18, max_log_2_filter_len=24,
            min_log_2_count_len=18, max_log_2_count_len=24)
STEPS = ("prepare", "dispatch", "count_readback", "finish_rest", "bloom_write")


def write_corpus(work: str, n: int = N, bp: int = BP) -> list[str]:
    """The JAX tool's FASTA files (one 300 bp read a record): their paths."""
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    paths = []
    for a in range(n):
        genome = lut[rng.integers(0, 4, size=bp // 4, dtype=np.uint8)]
        starts = rng.integers(0, genome.size - READ_LEN + 1, size=bp // READ_LEN)
        p = os.path.join(work, f"a{a}.fasta")
        with open(p, "wb") as f:
            for r, st in enumerate(starts):
                f.write(b">r%d\n" % r)
                f.write(genome[st : st + READ_LEN].tobytes())
                f.write(b"\n")
        paths.append(p)
    return paths


class DeviceClock:
    """CUDA events around a step on a card (ms), None elsewhere."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"

    def __enter__(self):
        if self.on:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self

    def __exit__(self, *exc):
        if self.on:
            self.end.record()

    def ms(self):
        if not self.on:
            return None
        self.end.synchronize()
        return self.start.elapsed_time(self.end)


def run_once(paths: list[str], opts: BuildOptions, out_dir: str, device: torch.device):
    """One batch, step by step: ({step: s}, {step: device ms}, records)."""
    t, dev = {}, {}
    t0 = time.perf_counter()
    prep = prepare_device_batch([(p, FilterInfo()) for p in paths], opts)
    t["prepare"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with DeviceClock(device) as clock:
        handles = dispatch_device_batch(prep, opts)
    t["dispatch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    handles[3].cpu()
    t["count_readback"] = time.perf_counter() - t0
    dev["dispatch"] = clock.ms()
    t0 = time.perf_counter()
    with DeviceClock(device) as clock:
        recs = finish_device_batch(prep, opts, handles)
    t["finish_rest"] = time.perf_counter() - t0
    dev["finish_rest"] = clock.ms()
    check(all(not isinstance(r, Exception) for r in recs), f"a record failed: {recs}")
    t0 = time.perf_counter()
    for p, rec in zip(paths, recs):
        write_bloom_file(os.path.join(out_dir, os.path.basename(p)[:-6] + ".bloom"), rec)
    t["bloom_write"] = time.perf_counter() - t0
    return t, dev, recs


def main(argv: list[str] | None = None) -> int:
    args = out_arg(__doc__, argv)
    device = bench_device()
    log = phase_log(device)
    work = tempfile.mkdtemp(prefix="kwage_build_phases_")
    try:
        paths = write_corpus(work, N, BP)
        out_dir = os.path.join(work, "bloom")
        os.makedirs(out_dir)
        opts = BuildOptions(**OPTS)
        run_once(paths, opts, out_dir, device)   # warm: first launches and allocations
        walls: dict[str, list[float]] = {s: [] for s in (*STEPS, "total")}
        device_ms: dict[str, list[float]] = {"dispatch": [], "finish_rest": []}
        for _ in range(REPS):
            t, dev, _ = run_once(paths, opts, out_dir, device)
            t["total"] = sum(t.values())
            for k, v in t.items():
                walls[k].append(v)
            for k, v in dev.items():
                if v is not None:
                    device_ms[k].append(v)
        same = []
        for p in paths:
            rec = read_bloom_file(os.path.join(out_dir, os.path.basename(p)[:-6] + ".bloom"))
            param, bits, _ = exact_bloom(fasta_reads(p), opts.kmer_len,
                                         opts.min_kmer_count,
                                         min_log_2_filter_len=opts.min_log_2_filter_len,
                                         max_log_2_filter_len=opts.max_log_2_filter_len)
            same.append(rec.param == param and rec.bits.tobytes() == bits.tobytes()
                        and rec.test_crc32())
        check(all(same), f".bloom files differ from the exact ground truth: {same}")
        for step, values in walls.items():
            extra = {}
            if device_ms.get(step):
                extra = {"device_median_ms": float(np.median(device_ms[step])),
                         "device_min_ms": float(np.min(device_ms[step]))}
            log.log(step, median_ms=1000 * float(np.median(values)),
                    min_ms=1000 * float(np.min(values)), runs=len(values), **extra)
        out = {"filters_per_sec_serial": N / float(np.median(walls["total"])),
               "accessions": N, "bp_per_accession": BP,
               "blooms_equal_ground_truth": True,
               "launches": {k: n for k, n in kernels.launch_counts().items() if n},
               "card": log.stamp["card"]}
        log.results.append(out)
        log.save(out_path(args.out, "build_phases"))
        print(json.dumps(out), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
