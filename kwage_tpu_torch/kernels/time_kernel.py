"""Time versions of one kernel source beside each other on one card.

    python -m kwage_tpu_torch.kernels.time_kernel KERNEL [other_version.cu ...]

KERNEL is ``kmers`` (``csrc/kmers.cu``), ``select_runs``
(``csrc/counting.cu``) or ``bit_transpose`` (``csrc/bit_transpose.cu``).
Each source (this tree's first, then the files named) is compiled alone
with ``nvcc`` for ``sm_90a`` into ``build/kwage_tpu_torch/`` and bound with
``ctypes``; these files have a plain C interface and no other source of the
package in them. Every version runs the kernel's cases below, must give the
first version's bytes, and is timed with CUDA events in the order
first .. last, last .. first; both readings are printed. A timed run
replays a CUDA graph of 20 launches, so the host's launch rate (5-6 us a
launch, above these kernels' time at the small shapes) is not in it. To
time an earlier commit's kernel: ``git show
<commit>:kwage_tpu_torch/csrc/counting.cu > build/counting_old.cu`` and
name that file. Exit code 1 when two versions disagree.

Cases. ``kmers``: the ASCII entry at SriRachA's batch shapes ([512, 256] at
k = 21 and 11, [4, 32768] and [512, 32768] at k = 21), at the one-query
shape [1, 256], and the packed entry at the ingest's fused batch
(1,048,576 x 256, k = 31). ``select_runs``: the fused batch's 236,978,176
sorted windows of 14 accessions at min_count 5 and 1, and the chunked
build's one-accession calls at n = 2^20, 2^18, 2^16, 2^14 and 4096
(min_count 5, 1, and 40: a look-ahead longer than the staged halo).
``bit_transpose``: a pack chunk [2048, 65,536], the ingest's [32, 65,536],
the squares and strips between [2048, 1024] and [32, 32] around the point
where the small-matrix kernel takes over, and the ragged [64, 130] and
[2080, 33].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import torch

from . import _ENTRIES, BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

GRAPH_LAUNCHES = 20


def load(source: str, entries: tuple[str, ...]) -> ctypes.CDLL:
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libtime_kernel_{tag}.so")
    if not os.path.exists(so):
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", so, source],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        print(f"{source}:\n{res.stdout}", flush=True)   # ptxas: registers, spills
        res.check_returncode()
    lib = ctypes.CDLL(so)
    for name in entries:
        fn = getattr(lib, "kw_" + name)
        fn.argtypes = _ENTRIES[name]
        fn.restype = ctypes.c_int
    return lib


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


# A case is (label, call(lib, stream) -> CUDA error code, the tensors the
# call writes as (tensor, fill value), replays of the graph in a timed
# run). The outputs are filled before each version's checked launch;
# ``num_valid`` with zeros, since select_runs adds into it.

def kmers_cases(device, gen):
    acgtn = torch.tensor(list(b"ACGTacgtN"), dtype=torch.uint8, device=device)
    shapes = [("ascii", 512, 256, 21), ("ascii", 512, 256, 11), ("ascii", 1, 256, 31),
              ("ascii", 4, 32768, 21), ("ascii", 512, 32768, 21), ("packed", 1 << 20, 256, 31)]
    for layout, R, L, k in shapes:
        nwin = L - k + 1
        words = torch.empty((R, nwin), dtype=torch.int64, device=device)
        valid = torch.empty((R, nwin), dtype=torch.uint8, device=device)
        if layout == "ascii":
            # One base in 512 an N: most windows valid, as in reads.
            pick = torch.randint(0, 8 * 512, (R, L), device=device, generator=gen)
            reads = acgtn[torch.where(pick % 512 == 0, 8, pick % 8)]

            def call(lib, st, reads=reads, words=words, valid=valid, R=R, L=L, k=k):
                return lib.kw_canonical_kmers_ascii(
                    reads.data_ptr(), words.data_ptr(), valid.data_ptr(), R, L, L, k, st)
        else:
            packed = torch.empty((R, L // 16), dtype=torch.int32, device=device).random_(
                -2**31, 2**31, generator=gen)
            vw = torch.full((R, L // 32), -1, dtype=torch.int32, device=device)
            vw[:, 3] = 0x7FFFFFFF

            def call(lib, st, packed=packed, vw=vw, words=words, valid=valid, R=R, L=L, k=k):
                return lib.kw_canonical_kmers(
                    packed.data_ptr(), vw.data_ptr(), words.data_ptr(), valid.data_ptr(), R,
                    L // 16, L // 32, L, k, st)
        yield f"{layout} [{R}, {L}] k={k}", call, [(words, -7), (valid, 9)], 20 if R * L <= 1 << 17 else 2


def select_runs_cases(device, gen):
    from ..ops.counting import sort_windows

    for n, num_acc in ((1_048_576 * 226, 14), (1 << 20, 1), (1 << 18, 1), (1 << 16, 1), (1 << 14, 1), (4096, 1)):
        # Sorted (acc, word) pairs from a pool (runs of ~8), ~30% invalid.
        pool = torch.randint(0, 1 << 62, (n // 8,), device=device, generator=gen)
        pick = torch.randint(0, n // 8, (n,), device=device, generator=gen)
        acc = (pick % (num_acc + 6)).clamp_(max=num_acc)
        acc_s, words_s = sort_windows(acc, pool[pick], 31, num_acc)
        del pool, pick, acc
        selected = torch.empty(n, dtype=torch.uint8, device=device)
        num_valid = torch.zeros(num_acc, dtype=torch.int32, device=device)
        for min_count in (5, 1) if n > 1 << 20 else (5, 1, 40):
            def call(lib, st, acc_s=acc_s, words_s=words_s, selected=selected,
                     num_valid=num_valid, n=n, num_acc=num_acc, min_count=min_count):
                return lib.kw_select_runs(acc_s.data_ptr(), words_s.data_ptr(),
                                          selected.data_ptr(), num_valid.data_ptr(), n,
                                          num_acc, min_count, st)
            yield (f"n={n} num_acc={num_acc} min_count={min_count}", call,
                   [(selected, 9), (num_valid, 0)], 20 if n <= 1 << 20 else 2)
        del acc_s, words_s, selected
        torch.cuda.empty_cache()


def bit_transpose_cases(device, gen):
    for F, W in ((2048, 65536), (32, 65536), (2048, 1024), (2048, 256), (512, 512), (512, 256), (256, 256), (64, 130), (32, 32), (2080, 33)):
        x = torch.empty((F, W), dtype=torch.int32, device=device).random_(
            -2**31, 2**31, generator=gen)
        out = torch.empty((W * 32, F // 32), dtype=torch.int32, device=device)

        def call(lib, st, x=x, out=out, F=F, W=W):
            return lib.kw_bit_transpose(x.data_ptr(), out.data_ptr(), F, W, st)
        yield f"[{F}, {W}]", call, [(out, 9)], 20 if F * W <= 1 << 21 else 2


# kernel -> (source in csrc/, its C entries, its cases)
KERNELS = {
    "kmers": ("kmers.cu", ("canonical_kmers", "canonical_kmers_ascii"), kmers_cases),
    "select_runs": ("counting.cu", ("select_runs",), select_runs_cases),
    "bit_transpose": ("bit_transpose.cu", ("bit_transpose",), bit_transpose_cases),
}


def main(argv: list[str]) -> int:
    if not argv or argv[0] not in KERNELS:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        print(f"KERNEL is one of {', '.join(KERNELS)}", file=sys.stderr)
        return 2
    source, entries, cases = KERNELS[argv[0]]
    sources = [os.path.join(CSRC_DIR, source), *argv[1:]]
    libs = [load(s, entries) for s in sources]
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for label, call, outputs, reps in cases(device, gen):
        results = []
        for lib in libs:
            for t, fill in outputs:
                t.fill_(fill)
            if call(lib, stream):
                raise RuntimeError("launch failed")
            results.append([t.clone() for t, _ in outputs])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for r in results[1:] for a, b in zip(r, results[0]))
        del results
        order = list(range(len(libs))) + list(reversed(range(len(libs))))
        times = [[] for _ in libs]
        for i in order:
            times[i].append(cuda_ms(lambda st, lib=libs[i]: call(lib, st), reps))
        print(f"{argv[0]} {label}: " + "; ".join(
            f"{os.path.basename(s)} {t[0]:.4f} / {t[1]:.4f} ms" for s, t in zip(sources, times))
            + f"; outputs equal: {same}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
