"""Time versions of ``csrc/kmers.cu`` beside each other on one card.

    python -m kwage_tpu_torch.kernels.time_kmers [other_kmers.cu ...]

Each source (this tree's ``csrc/kmers.cu`` first, then the files named) is
compiled alone with ``nvcc`` for ``sm_90a`` into ``build/kwage_tpu_torch/``
and bound with ``ctypes``; the file has a plain C interface and no other
source of the package in it. Every version runs the ASCII entry at
SriRachA's batch shapes ([512, 256] at k = 21 and 11, [4, 32768] and
[512, 32768] at k = 21), at the one-query shape [1, 256], and the packed
entry at the ingest's fused batch (1,048,576 x 256, k = 31), must give the
first version's bytes, and is timed with CUDA events in the order
first .. last, last .. first; both readings are printed. A timed run
replays a CUDA graph of 20 launches, so the host's launch rate (5-6 us a
launch, above these kernels' time at the small shapes) is not in it. To
time an earlier commit's kernel: ``git show
<commit>:kwage_tpu_torch/csrc/kmers.cu > build/kmers_old.cu`` and name
that file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import torch

from . import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

_VP, _I64 = ctypes.c_void_p, ctypes.c_int64


def load(source: str) -> ctypes.CDLL:
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libtime_kmers_{tag}.so")
    if not os.path.exists(so):
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", so, source], check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    lib = ctypes.CDLL(so)
    lib.kw_canonical_kmers.argtypes = [_VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _I64, _VP]
    lib.kw_canonical_kmers_ascii.argtypes = [_VP, _VP, _VP, _I64, _I64, _I64, _I64, _VP]
    return lib


GRAPH_LAUNCHES = 20


def cuda_ms(call, reps: int) -> float:
    """Mean ms of one launch of ``call(stream)`` over ``reps`` replays of a
    graph of GRAPH_LAUNCHES launches."""
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(GRAPH_LAUNCHES):
            if call(side.cuda_stream):
                raise RuntimeError("launch failed")
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * GRAPH_LAUNCHES)


def main(argv: list[str]) -> int:
    sources = [os.path.join(CSRC_DIR, "kmers.cu"), *argv]
    libs = [load(s) for s in sources]
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    acgtn = torch.tensor(list(b"ACGTacgtN"), dtype=torch.uint8, device=device)
    cases = [("ascii", 512, 256, 21), ("ascii", 512, 256, 11), ("ascii", 1, 256, 31),
             ("ascii", 4, 32768, 21), ("ascii", 512, 32768, 21), ("packed", 1 << 20, 256, 31)]
    for layout, R, L, k in cases:
        nwin = L - k + 1
        words = torch.empty((R, nwin), dtype=torch.int64, device=device)
        valid = torch.empty((R, nwin), dtype=torch.uint8, device=device)
        if layout == "ascii":
            # One base in 512 an N: most windows valid, as in reads.
            pick = torch.randint(0, 8 * 512, (R, L), device=device, generator=gen)
            reads = acgtn[torch.where(pick % 512 == 0, 8, pick % 8)]
            calls = [lambda st, lib=lib: lib.kw_canonical_kmers_ascii(
                reads.data_ptr(), words.data_ptr(), valid.data_ptr(), R, L, L, k, st)
                for lib in libs]
        else:
            packed = torch.empty((R, L // 16), dtype=torch.int32, device=device).random_(
                -2**31, 2**31, generator=gen)
            vw = torch.full((R, L // 32), -1, dtype=torch.int32, device=device)
            vw[:, 3] = 0x7FFFFFFF
            calls = [lambda st, lib=lib: lib.kw_canonical_kmers(
                packed.data_ptr(), vw.data_ptr(), words.data_ptr(), valid.data_ptr(), R,
                L // 16, L // 32, L, k, st) for lib in libs]
        outs = []
        for call in calls:
            words.fill_(-7)
            valid.fill_(9)
            if call(stream):
                raise RuntimeError("launch failed")
            outs.append((words.clone(), valid.clone()))
        same = all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
                   for o in outs[1:])
        reps = 20 if R * L <= 1 << 17 else 2
        order = list(range(len(calls))) + list(reversed(range(len(calls))))
        times = [[] for _ in calls]
        for i in order:
            times[i].append(cuda_ms(calls[i], reps))
        print(f"{layout} [{R}, {L}] k={k}: " + "; ".join(
            f"{os.path.basename(s)} {t[0]:.4f} / {t[1]:.4f} ms" for s, t in zip(sources, times))
            + f"; outputs equal: {same}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
