"""SriRachA's device path as a model of its terms: the port's counterpart
of ``tools/bench_sriracha_model.py``.

    python3 -m kwage_tpu_torch.bench.sriracha_model [--out PATH]

Per span of reads (steady state, the span pipeline one deep):

    wall = max(t_pack_dispatch, t_kernel) + t_sync + t_gate
    t_sync(RTT) ~= 3 * RTT (+ the readback)      end to end = span_bp / wall

Measured here: t_pack_dispatch, t_sync and t_gate from
``search_reads_device(profile=...)`` (``sriracha/device.py``), each a span's
mean; t_kernel from the path's launches (one ``sriracha_reads_hash``) on
one [512, 128] batch of the same reads, CUDA events over a CUDA graph
(``bench.sriracha.kernel_ms``), scaled to a span; and the end to end, whose
wall the model must explain (``model_vs_measured_ratio``). The model is
then projected at RTT 0, 1, 10 and 60 ms. The RTT now is inferred as a
third of t_sync: on a local PCIe card that is the latency of a span's
launches, copies and event wait, not a network's.

Workload (the JAX tool's; env SRIRACHA_K 21, SRIRACHA_NREADS 16384,
SRIRACHA_READ_LEN 100, SRIRACHA_NSUBJ 4): 4 subjects of 2000 bases from
one 8000-base target, reads from ``default_rng(0)``, a third of them
sampled from the target; threshold 0.3, batches of 512, spans of 16
batches; a warm pass of two spans first. Check: the device matches equal
the port's host engine's (``sriracha.engine.search_reads``) on the same
reads. One JSON line a phase with the card's name and power limit, then
the JAX tool's result object.

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
from ..sriracha import device as tsr
from ..sriracha.engine import SrirachaOptions, canonical_kmers, search_reads
from ._common import bench_device, check, out_arg, out_path, phase_log
from .sriracha import kernel_ms

K = int(os.environ.get("SRIRACHA_K", "21"))
NREADS = int(os.environ.get("SRIRACHA_NREADS", "16384"))
READ_LEN = int(os.environ.get("SRIRACHA_READ_LEN", "100"))
NSUBJ = int(os.environ.get("SRIRACHA_NSUBJ", "4"))
BATCH = 512
SPAN = 16 * BATCH
RTTS_MS = {"rtt_0": 0.0, "rtt_1ms": 1.0, "rtt_10ms": 10.0, "rtt_60ms": 60.0}


def make_inputs(k: int = K, nreads: int = NREADS, read_len: int = READ_LEN,
                nsubj: int = NSUBJ):
    """The JAX tool's subjects (name, sorted distinct canonical k-mers) and
    reads (sequence, read index, 0), from one ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    target = lut[rng.integers(0, 4, size=8000)].tobytes().decode()
    subjects = [(f"subj{s}", np.unique(canonical_kmers(target[s * 1500:s * 1500 + 2000], k)))
                for s in range(nsubj)]
    reads = []
    for i in range(nreads):
        if i % 3 == 0:
            st = int(rng.integers(0, len(target) - read_len))
            seq = target[st:st + read_len]
        else:
            seq = lut[rng.integers(0, 4, size=read_len)].tobytes().decode()
        reads.append((seq, i + 1, 0))
    return subjects, reads


def options(k: int = K) -> SrirachaOptions:
    return SrirachaOptions(kmer_len=k, kmer_match_threshold=0.3, min_valid_kmer=1,
                           max_num_match=10)


def main(argv: list[str] | None = None) -> int:
    args = out_arg(__doc__, argv)
    device = bench_device()
    log = phase_log(device)
    subjects, reads = make_inputs(K, NREADS, READ_LEN, NSUBJ)
    opt = options(K)
    total_bp = sum(len(r[0]) for r in reads)

    tsr.search_reads_device(iter(reads[:2 * SPAN]), subjects, opt, batch_size=BATCH,
                            span_reads=SPAN, device=device)
    prof: dict = {}
    t0 = time.perf_counter()
    res = tsr.search_reads_device(iter(reads), subjects, opt, batch_size=BATCH,
                                  span_reads=SPAN, profile=prof, device=device)
    wall = time.perf_counter() - t0
    want = search_reads(iter(reads), subjects, opt)
    check(res == want, "the device matches differ from the host engine's")
    n_matches = [len(r) for r in res]
    log.log("end_to_end", wall_s=wall, spans=prof["spans"], matches=n_matches,
            equal_to_host_engine=True)

    spans = prof["spans"]
    pack, sync, gate = (prof[key] / spans for key in ("pack_dispatch_s", "sync_s", "gate_s"))
    span_bp = total_bp / spans

    block = np.zeros((BATCH, 128), dtype=np.uint8)
    for r in range(BATCH):
        seq = reads[r][0].encode()
        block[r, :len(seq)] = np.frombuffer(seq, dtype=np.uint8)
    lengths = torch.full((BATCH,), READ_LEN, dtype=torch.int32, device=device)
    tables = tsr.build_hash_tables(subjects, K, device)
    t_batch_ms = kernel_ms(torch.from_numpy(block).to(device), lengths, tables)
    kernel_mbps = BATCH * READ_LEN / (t_batch_ms * 1e-3) / 1e6
    t_kernel_span = span_bp / (kernel_mbps * 1e6)
    log.log("kernel", batch_ms=t_batch_ms, kernel_mbps=kernel_mbps, route=tables.route)

    rtt_now = sync / 3

    def rate(rtt_s: float) -> float:
        return span_bp / (max(pack, t_kernel_span) + 3 * rtt_s + gate) / 1e6

    measured_mbps = total_bp / wall / 1e6
    out = {
        "workload": {"k": K, "reads": NREADS, "read_len": READ_LEN, "subjects": NSUBJ,
                     "span_reads": SPAN, "total_mbp": total_bp / 1e6},
        "measured": {
            "end_to_end_mbps": measured_mbps,
            "kernel_mbps": kernel_mbps,
            "per_span_s": {"pack_dispatch": pack, "kernel": t_kernel_span, "sync": sync,
                           "gate": gate},
            "inferred_rtt_ms": rtt_now * 1e3,
            "rtt_note": ("a local PCIe card: the inferred RTT is a span's launch, copy and "
                         "event-wait latency, not a network round trip"
                         if device.type == "cuda" else "CPU run: no device figure"),
        },
        "model": {
            "formula": "span_bp / (max(pack, kernel) + 3*RTT + gate)",
            "predicted_at_current_rtt_mbps": rate(rtt_now),
            "projected_mbps": {name: rate(ms * 1e-3) for name, ms in RTTS_MS.items()},
        },
        "model_vs_measured_ratio": rate(rtt_now) / measured_mbps if measured_mbps else None,
        "matches_equal_host_engine": True,
        "launches": {k: n for k, n in kernels.launch_counts().items() if n},
        "card": log.stamp["card"],
    }
    log.results.append(out)
    log.save(out_path(args.out, "sriracha_model"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
