"""Time versions of one kernel source beside each other on one card.

    python -m kwage_tpu_torch.kernels.time_kernel KERNEL [other_version.cu ...]

KERNEL is ``kmers`` (``csrc/kmers.cu``), ``select_runs``
(``csrc/counting.cu``), ``bit_transpose`` (``csrc/bit_transpose.cu``),
``sort`` (``csrc/sort.cu``), ``bitset`` (``csrc/bitset.cu``), ``search``
(``csrc/search.cu``), ``murmur`` (``csrc/murmur.cu``) or ``roof``
(``csrc/variants/int_roof.cu``, the card's integer rate). Each source (this
tree's first, then the files named) is compiled alone with ``nvcc`` for
``sm_90a`` (``-I csrc/``, for ``murmur.cuh`` and ``kmers.cuh``; a header beside the source
wins) into ``build/kwage_tpu_torch/`` and bound with ``ctypes``; these
files have a plain C interface and no other source of the package in them.
Every version runs the kernel's cases below, must give the first version's
bytes, and is timed with CUDA events in the order first .. last, last ..
first; both readings are printed. A timed run of a small case replays a
CUDA graph of 20 launches, so the host's launch rate (5-6 us a launch,
above these kernels' time at the small shapes) is not in it; the cases of
milliseconds are launched a few times in a row. To time an earlier
commit's kernel: ``git show <commit>:kwage_tpu_torch/csrc/counting.cu >
build/counting_old.cu`` and name that file (for ``bitset.cu`` and
``murmur.cu``, put that commit's ``murmur.cuh`` beside it). Where a C entry's arguments changed
(``radix_sort_pairs``; ``search_total_hits`` gained a scratch;
``merge_counts`` now folds its pairs itself), each version is called with
its own. Exit code 1 when two versions disagree.

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
[2080, 33]. ``sort`` (k = 31): 236,978,176 windows of 14 accessions, 30%
invalid, all pairs and the valid pairs only (a version that cannot drop
windows sorts all, and its valid prefix is compared); the fused batch's
own layout, 67,200,000 valid windows (rows of 120 valid of 226) of
236,978,176, valid only; 2^24 windows of one accession, half invalid,
valid only.
``bitset``: phase 4's shape (236,978,176 sorted windows, 5-fold runs
selected, 14 filters, L = 21) at 4 seeds and at 1 (the atomics alone),
and 4 filters of 2^30 bits (offsets past 2^31). ``search``: ``search_complete``,
``search_counts`` and ``search_total_hits`` at phase 4's shape (R = 2^22,
W = 512, 8 queries of 1024 positions with 1, 3, 1024, 1000, 777, 512, 129
and 0 valid, nh = 5), on its W = 131 and W = 128 column shards, on 64
queries with all 1024 k-mers valid, and at R = 2^26, W = 64; each line
ends with the share of the function's byte bound. ``murmur``: ``murmur32``
as slice indices at the ingest's shape (n = 2^23 distinct words, k = 31,
nh = 4, L = 21) and at ``entry()``'s (n = 226, nh = 5, L = 14); each line
ends with the share of the function's bound (the larger of its integer
operations over the two pipes' issue limit and its bytes), and before the cases each
version's SASS mix at k = 31, nh = 4 is printed (``cuobjdump -sass``:
instructions by opcode, the ALU pipe's and the FMA pipe's, and the time
the ALU pipe's alone take at 2^23 k-mers). ``merge``: ``run_counts`` and
``merge_counts`` at a 46 Mbp accession's shape and at a real accession's
(a chunk of 2^27 windows; 2^28 + 2^26 words merged), beside the parent's
source (``git show 54a751d:kwage_tpu_torch/csrc/merge.cu``), whose merge is
its merge kernel and a run_counts fold; each line ends with the share of
the byte bound, and run_counts' with torch.unique_consecutive's time.
``roof``: chains of int32
IMAD and LOP3 on every SM, together and each alone; it prints T ops/s,
the SM clock it ran at and the operations a clock and SM.

``sriracha`` times the routes of the package's own library
(``kernels.build``) and the entries of any other ``sriracha.cu``,
``sriracha_block_lut.cu`` or ``sriracha_block_hash.cu`` named, each
compiled alone (its headers, ``kmers.cuh``, ``sriracha.cuh`` and
``sriracha_block.cuh``, beside it or in csrc/; a ``sriracha.cu`` whose
``sriracha_counts_*`` calls the block kernel's words entries links
``sriracha_words_lut.cu`` and ``sriracha_words_hash.cu`` from there too):
SriRachA's fused entries (``sriracha_reads_lut`` / ``_hash``, a warp a
read, and ``sriracha_block_lut`` / ``_hash``, a block a read), the words
entry ``sriracha_counts_lut`` / ``_hash`` alone on the batch's canonical
words (this library's and each other ``sriracha.cu``'s), and the two
launches a wide batch takes (``canonical_kmers_ascii`` +
``sriracha_counts_*``), at phase 8's batch ([512, 256] of 150 bp reads,
40 subjects of 30 kbp, k = 11 on the LUT and k = 21 on the hash),
``bench.sriracha``'s step ([512, 128], k = 21, its 4 subjects), a whole
span ([8192, 256], both), reads of 1.5 kbp and 15 kbp in the block
kernel's buckets ([512, 2048], [64, 16384] and [512, 16384], both k), and
two batches of the 32768 bucket, where only the words entry runs: [4,
32768] holding reads of 2^15 bases and 20 kbp, and [8, 32768] holding
rows of 0, k - 1, 16385, 16384 + k - 1 and 16384 + k bases (both sides
of 2^14 windows) and of 20, 26 and 32 kbp (both k). A source without an
entry is left out where it lacks it. Each route must give
``read_batch_counts_ref``'s bytes; each is timed in a CUDA graph
(``sriracha_routes``, which chip_smoke.py's phase 4 also runs), and each
ends with the share of its bound: ``bench.sriracha.reads_work`` from
ASCII (the reads, the lengths, the counts and the table bytes of every
read's distinct valid words, or its operations), ``counts_work`` for the
words entry alone (the 9 bytes of every window that fits its read in
place of the reads). nvcc's registers and spills of the block and warp
kernels' instances are printed first.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import re
import subprocess
import sys
from typing import Callable

import numpy as np
import torch

from . import _ENTRIES, _I64, _VP, BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc

GRAPH_LAUNCHES = 20
# The card's peaks: 3.35 TB/s of HBM3 (NVIDIA H100 SXM data sheet); int32
# operations: two pipes, IMAD on the FMA pipe and LOP3 (and the adds and
# shifts) on the integer ALU, each 64 lanes a clock and SM, at 132 SMs and
# 1.98 GHz. Chains of IMAD alone and of LOP3 alone each ran at 63.3-63.8 a
# clock and SM at 1.98-1.995 GHz on an H100 80GB HBM3 at 700.00 W (``roof``,
# csrc/variants/int_roof.cu); their mix reached 87-88 a clock and SM, not
# the 128 of both pipes full, so the peak is what two full pipes dispatch,
# not that reading. ONE_PIPE_OPS_PER_S: one pipe at that 63.5, the floor of
# a kernel whose operations mostly issue to one pipe.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 2 * 64 * 132 * 1.98e9
ONE_PIPE_OPS_PER_S = 63.5 * 132 * 1.98e9
# C entries of the sources built alone: int_roof (out, grid, steps, mode,
# stream); gather1 and gather5_and (variants/search_phases.cu, for
# bench.search_phases) take search_complete's arguments.
_OWN_ENTRIES = {"int_roof": [_VP, _I64, _I64, _I64, _VP],
                "gather1": _ENTRIES["search_complete"],
                "gather5_and": _ENTRIES["search_complete"]}
# Entries whose arguments changed: name -> (the entry only the current
# version has, the earlier version's argument types).
_EARLIER = {
    # (acc, words, acc_a, words_a, acc_b, words_b, hist, totals, n,
    #  word_digits, acc_digits, stream)
    "radix_sort_pairs": ("radix_sort_hist", [_VP] * 8 + [_I64] * 3 + [_VP]),
    # (db, idx, valid, tcount, out, nq, nk, nh, W, stream): no scratch
    "search_total_hits": ("search_scratch_words", [_VP] * 5 + [_I64] * 4 + [_VP]),
    # (words_a, counts_a, words_b, counts_b, words_out, counts_out, part, na,
    #  nb, stream): the merge alone, folded by run_counts after it
    "merge_counts": ("merge_scratch_words", [_VP] * 7 + [_I64] * 2 + [_VP]),
}


def companions(source: str) -> list[str]:
    """The sources a ``sriracha.cu`` links with: the block kernel's words
    entries (``sriracha_words_lut.cu``, ``sriracha_words_hash.cu``, beside
    it or in csrc/) where it calls them; none for another source."""
    with open(source) as f:
        if "kw_sriracha_words_" not in f.read():
            return []
    return [next(p for p in (os.path.join(os.path.dirname(source), name),
                             os.path.join(CSRC_DIR, name)) if os.path.exists(p))
            for name in ("sriracha_words_lut.cu", "sriracha_words_hash.cu")]


def build_alone(source: str) -> tuple[str, str | None]:
    """Compile ``source`` alone (``-I csrc/``), with its ``companions``, into
    a shared library under BUILD_DIR, named by a sha256 of their bytes and
    of the ``murmur.cuh``, ``kmers.cuh``, ``search.cu``, ``sriracha.cuh`` and
    ``sriracha_block.cuh`` beside it or in csrc/ (headers it may include);
    return (its path, nvcc's report, or None when that build existed). The
    library appears whole or not at all, so processes may build it at
    once."""
    tag = hashlib.sha256()
    units = [source, *companions(source)]
    for path in (*units, *(os.path.join(d, name) for d in (os.path.dirname(source), CSRC_DIR)
                           for name in ("murmur.cuh", "kmers.cuh", "search.cu", "sriracha.cuh",
                                        "sriracha_block.cuh"))):
        if os.path.exists(path):
            with open(path, "rb") as f:
                tag.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libtime_kernel_{tag.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, None
    tmp = f"{so}.{os.getpid()}"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-shared", "-o", tmp, *units],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {source}:\n{res.stdout}")
    os.replace(tmp, so)
    return so, res.stdout


def load(source: str, entries: tuple[str, ...]) -> ctypes.CDLL:
    """Compile ``source`` alone (``build_alone``) and bind the ``entries``
    it exports."""
    so, report = build_alone(source)
    if report is not None:
        print(f"{source}:\n{ptxas_report(report)}", flush=True)
    lib = ctypes.CDLL(so)
    for name in entries:
        if not hasattr(lib, "kw_" + name):
            continue
        fn = getattr(lib, "kw_" + name)
        fn.argtypes = _ENTRIES.get(name) or _OWN_ENTRIES[name]
        if name in _EARLIER and not hasattr(lib, "kw_" + _EARLIER[name][0]):
            fn.argtypes = _EARLIER[name][1]
        fn.restype = ctypes.c_int
    return lib


def murmur_ops(k: int, nh: int) -> int:
    """Integer operations of murmur3-32 over one k-mer's decoded bases for
    nh seeds, masked. The decode: 2 to bit-reverse and shift the word, 5 a
    pair of 4-base message blocks to spread their 2-bit codes to nibbles
    (one byte permute, two shift-and-mask steps), 1 a block to map them to
    ASCII and 3 to mix it, 1 to cut the tail block. A seed: 3 a full block
    (xor, rotate, multiply-add), 1 for the tail, 10 for the finish and the
    mask (the length, three shift-xors, two multiplies, the and)."""
    blocks, tail = -(-k // 4), k % 4 != 0
    decode = 2 + 5 * -(-blocks // 2) + 4 * blocks + tail
    return decode + nh * (3 * (k // 4) + tail + 10)


def ptxas_report(text: str, most: int = 24) -> str:
    """nvcc's output; where ptxas reports more than ``most`` kernels (the
    instances of a template), one line: their count, the range of their
    registers and their spills."""
    kernels = re.findall(r"Compiling entry function '(\S+)'", text)
    if len(kernels) <= most:
        return text
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores", text)})
    return (f"ptxas: {len(kernels)} kernels, {min(regs)}-{max(regs)} registers, "
            f"spill stores {spills} bytes")


def cuda_ms(call, reps: int, graph: bool = True) -> float:
    """Mean ms of one launch of ``call(stream)`` over ``reps`` replays of a
    graph of GRAPH_LAUNCHES launches; ``graph`` False: over ``reps``
    launches in a row after one warm-up (cases of milliseconds)."""
    if not graph:
        stream = torch.cuda.current_stream().cuda_stream
        if call(stream):
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            if call(stream):
                raise RuntimeError("launch failed")
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
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


@dataclasses.dataclass
class Case:
    """``call(lib, stream)`` -> CUDA error code; ``outputs``: the tensors
    the call writes, as (tensor, fill value), filled before each version's
    checked launch (``num_valid`` with zeros, since select_runs adds into
    it); ``reps``: replays of the graph (or launches) in a timed run;
    ``result(lib)``: the tensors to compare, where they are not the
    outputs; ``ops``: the operations of one launch, for a rate;
    ``note(ms)``: text printed after the fastest reading."""
    label: str
    call: Callable
    outputs: list
    reps: int
    result: Callable | None = None
    ops: int | None = None
    graph: bool = True
    note: Callable | None = None


# A case generator yields Cases.

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
        yield Case(f"{layout} [{R}, {L}] k={k}", call, [(words, -7), (valid, 9)],
                   20 if R * L <= 1 << 17 else 2)


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
            yield Case(f"n={n} num_acc={num_acc} min_count={min_count}", call,
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
        yield Case(f"[{F}, {W}]", call, [(out, 9)], 20 if F * W <= 1 << 21 else 2)


SORT_K, SORT_NUM_ACC = 31, 14
FUSED_ROWS, FUSED_NWIN = 1 << 20, 226          # the ingest's fused batch
FUSED_LIVE_ROWS, FUSED_LIVE_WIN = 560_000, 120   # 14 x 40,000 reads, 150 bp


def fused_batch_pairs(rows: int, nwin: int, live_rows: int, valid_per_row: int,
                      num_acc: int, gen, device, k: int = SORT_K):
    """int64 (acc, word) windows laid out as the ingest's fused batch: rows
    of ``nwin`` windows; the first ``live_rows`` hold reads of accessions
    0 .. num_acc - 1 in equal runs of rows, the first ``valid_per_row``
    windows of a live row valid; every other window carries num_acc. The
    words: about 400,000 distinct k-mers an accession (a 400 kbp genome),
    drawn at random."""
    row = torch.arange(rows, device=device)
    acc = torch.where(row < live_rows, row // -(-live_rows // num_acc),
                      num_acc)[:, None].repeat(1, nwin)
    acc[:, valid_per_row:] = num_acc
    acc = acc.reshape(-1)
    distinct = 400_000
    pool = torch.randint(0, 1 << (2 * k), (num_acc * distinct,), device=device, generator=gen)
    pick = torch.randint(0, distinct, acc.shape, device=device, generator=gen)
    return acc, pool[acc.clamp(max=num_acc - 1) * distinct + pick]


def _ingest_pairs(device, gen, layout: str):
    """int64 (acc, word) windows, k = 31. "random": 236,978,176 windows of
    14 accessions from a pool (runs of ~8), a word kept to one accession,
    30% invalid; "fused": the fused batch's layout (fused_batch_pairs),
    rows of 226 windows of which the first 120 are valid in 560,000 rows
    of 14 accessions; "chunk": 2^24 windows of one accession, half
    invalid."""
    if layout == "fused":
        return fused_batch_pairs(FUSED_ROWS, FUSED_NWIN, FUSED_LIVE_ROWS, FUSED_LIVE_WIN,
                                 SORT_NUM_ACC, gen, device)
    n, num_acc, invalid = ((FUSED_ROWS * FUSED_NWIN, SORT_NUM_ACC, 6) if layout == "random"
                           else (1 << 24, 1, 1))
    pool = torch.randint(0, 1 << (2 * SORT_K), (n // 8,), device=device, generator=gen)
    pick = torch.randint(0, n // 8, (n,), device=device, generator=gen)
    return (pick % (num_acc + invalid)).clamp_(max=num_acc), pool[pick]


def sort_case(label, acc, words, num_acc, valid_only):
    """One sort of (acc, words) through either version of csrc/sort.cu over
    buffers made once: the current one's two entries (histogram, passes;
    ``valid_only`` drops the windows outside [0, num_acc)), or an earlier
    one's single entry (8-bit digits; all pairs, its valid prefix compared)."""
    from ..ops.counting import _ACC_DTYPES, SORT_TILE, sort_acc_bytes, sort_plan

    device, n = acc.device, acc.shape[0]
    limit = num_acc if valid_only else 0
    n_kept = int(((acc >= 0) & (acc < num_acc)).sum()) if valid_only else n
    acc_bits = (num_acc - 1 if valid_only else num_acc).bit_length()
    plan = sort_plan(SORT_K, acc_bits)
    passes, widths = len(plan), sum(w << (4 * p) for p, (_, w) in enumerate(plan))
    empty = lambda m, dtype=torch.int64: torch.empty(m, dtype=dtype, device=device)  # noqa: E731
    hist, kept, counters = empty(sum(1 << w for _, w in plan), torch.int32), empty(1), \
        empty(16, torch.int32)
    words_a, words_b, acc_out = empty(n_kept), empty(n_kept), torch.zeros_like(empty(n_kept))
    ab = sort_acc_bytes(acc_bits)
    acc_a = acc_b = None
    if ab:
        acc_a, acc_b = empty(n_kept, _ACC_DTYPES[ab]), empty(n_kept, _ACC_DTYPES[ab])
    entries = max(-(-(n if p == 0 else n_kept) // SORT_TILE) << w for p, (_, w) in enumerate(plan))
    lookback = empty(entries)
    old_digits = (-(-2 * SORT_K // 8), -(-num_acc.bit_length() // 8))
    old = [(empty(n), empty(n)), (empty(n), empty(n))]
    old_hist, old_totals = empty(256 * -(-n // SORT_TILE), torch.int32), empty(256, torch.int32)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731

    def call(lib, st):
        if hasattr(lib, "kw_radix_sort_hist"):
            return (lib.kw_radix_sort_hist(acc.data_ptr(), words.data_ptr(), hist.data_ptr(),
                                           kept.data_ptr(), n, limit, 2 * SORT_K, acc_bits,
                                           widths, passes, st)
                    or lib.kw_radix_sort_pairs(
                        acc.data_ptr(), words.data_ptr(), ptr(acc_a), ptr(acc_b),
                        words_a.data_ptr(), words_b.data_ptr(), acc_out.data_ptr(),
                        hist.data_ptr(), lookback.data_ptr(), counters.data_ptr(), n, n_kept,
                        limit, 2 * SORT_K, acc_bits, widths, passes, entries, st))
        return lib.kw_radix_sort_pairs(acc.data_ptr(), words.data_ptr(), old[0][0].data_ptr(),
                                       old[0][1].data_ptr(), old[1][0].data_ptr(),
                                       old[1][1].data_ptr(), old_hist.data_ptr(),
                                       old_totals.data_ptr(), n, *old_digits, st)

    def result(lib):
        if hasattr(lib, "kw_radix_sort_hist"):
            return [acc_out, words_a]
        a, w = old[(sum(old_digits) - 1) & 1]
        return [a[:n_kept], w[:n_kept]]
    return Case(f"{label}: {n_kept} of {n} pairs kept, {passes} passes (earlier version: "
                f"{sum(old_digits)})", call, [], 3, result, graph=False)


def sort_cases(device, gen):
    acc, words = _ingest_pairs(device, gen, "random")
    yield sort_case("30% invalid, all pairs", acc, words, SORT_NUM_ACC, False)
    yield sort_case("30% invalid, valid only", acc, words, SORT_NUM_ACC, True)
    del acc, words
    torch.cuda.empty_cache()
    acc, words = _ingest_pairs(device, gen, "fused")
    yield sort_case("the fused batch's layout, valid only", acc, words, SORT_NUM_ACC, True)
    del acc, words
    torch.cuda.empty_cache()
    acc, words = _ingest_pairs(device, gen, "chunk")
    yield sort_case("2^24 windows of one accession, valid only", acc, words, 1, True)


def bitset_cases(device, gen):
    from ..ops.counting import select_runs, sort_windows, words_per_filter

    acc, words = _ingest_pairs(device, gen, "random")
    acc_s, words_s = sort_windows(acc, words, SORT_K, SORT_NUM_ACC)
    del acc, words
    sel, nv = select_runs(acc_s, words_s, SORT_NUM_ACC, 5)
    shapes = [(acc_s, words_s, sel, SORT_NUM_ACC, 21, 4), (acc_s, words_s, sel, SORT_NUM_ACC, 21, 1)]
    n = 1 << 20
    small = (torch.randint(0, 5, (n,), device=device, generator=gen),
             torch.randint(0, 1 << 62, (n,), device=device, generator=gen),
             torch.rand((n,), device=device, generator=gen) < 0.5)
    shapes.append((*small, 4, 30, 3))
    for a, w, f, num_acc, L, nh in shapes:
        slot = torch.tensor(list(range(num_acc)) + [-1], dtype=torch.int32, device=device)
        out = torch.empty((num_acc, words_per_filter(L)), dtype=torch.int32, device=device)

        def call(lib, st, a=a, w=w, f=f, slot=slot, out=out, num_acc=num_acc, L=L, nh=nh):
            return lib.kw_bloom_set_bits(a.data_ptr(), w.data_ptr(), f.data_ptr(),
                                         slot.data_ptr(), out.data_ptr(), a.shape[0], num_acc,
                                         SORT_K, nh, L, out.shape[1], st)
        yield Case(f"n={a.shape[0]} selected={int(f.sum())} num_acc={num_acc} L={L} nh={nh}",
                   call, [(out, 0)], 5, graph=False)


def roof_cases(device, gen):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid, steps = 8 * sms, 20_000
    clocks = torch.zeros(3, dtype=torch.int64, device=device)

    def per_clock(ms):
        """The SM clock of the last launch (block 0's cycles over its
        nanoseconds) and the rate in operations a clock and SM."""
        cycles, ns = clocks[:2].tolist()
        ghz = cycles / ns
        return f", SM clock {ghz:.4f} GHz, {ops / (ms * 1e6 * ghz * sms):.2f} a clock and SM"

    ops = grid * 256 * 8 * 2 * steps
    for mode, label in ((0, "IMAD + LOP3"), (1, "IMAD"), (2, "LOP3")):
        def call(lib, st, mode=mode):
            return lib.kw_int_roof(clocks.data_ptr(), grid, steps, mode, st)
        yield Case(f"{label}: {grid} blocks x 256 threads x 8 chains x {steps} steps", call,
                   [(clocks, 0)], 3, result=lambda lib: [], ops=ops, graph=False,
                   note=per_clock)


SEARCH_NH = 5
SEARCH_MAIN = [1, 3, 1024, 1000, 777, 512, 129, 0]   # chip_smoke.py phase 4's valid k-mers


def _search_shape(tag, db, n_valid, gen):
    """The three searches over ``db`` for queries of n_valid valid k-mers
    (a prefix of max(n_valid) positions each), nh = 5, thresholds at each
    query's mean count."""
    device, (R, W) = db.device, db.shape
    nq, nk = len(n_valid), max(n_valid)
    idx = torch.randint(0, R, (nq, nk, SEARCH_NH), dtype=torch.int32, device=device,
                        generator=gen)
    idx[0, 0, 0] = R - 1
    valid = torch.zeros((nq, nk), dtype=torch.bool, device=device)
    for q, n in enumerate(n_valid):
        valid[q, :n] = True
    tcount = torch.tensor([max(1, n >> SEARCH_NH) for n in n_valid], dtype=torch.int32,
                          device=device)
    scratch = torch.empty(nq * W * 32, dtype=torch.int32, device=device)  # total_hits' counts
    gathered = sum(n_valid) * SEARCH_NH * W * 4
    for name, cols, fill in (("search_complete", W, -7), ("search_counts", W * 32, -7),
                             ("search_total_hits", 1, 0)):
        out = torch.empty((nq, cols), dtype=torch.int32, device=device)
        nbytes = gathered + 4 * idx.numel() + valid.numel() + 4 * out.numel()
        bound = (nbytes + (4 * nq if cols == 1 else 0)) / HBM_BYTES_PER_S * 1e3

        def call(lib, st, name=name, out=out):
            ptrs = [db.data_ptr(), idx.data_ptr(), valid.data_ptr()]
            if name == "search_total_hits":
                ptrs += [tcount.data_ptr(), out.data_ptr()]
                if hasattr(lib, "kw_search_scratch_words"):
                    ptrs.append(scratch.data_ptr())
            else:
                ptrs.append(out.data_ptr())
            return getattr(lib, "kw_" + name)(*ptrs, nq, nk, SEARCH_NH, W, st)
        yield Case(f"{tag} R={R} W={W} nq={nq} nk={nk} valid={sum(n_valid)}: {name}", call,
                   [(out, fill)], 20,
                   note=lambda ms, bound=bound: f"{bound / ms:.3f} of the {bound:.4f} ms "
                                                "byte bound")


def search_cases(device, gen):
    """The three searches of csrc/search.cu at phase 4's shape (R = 2^22,
    W = 512, 8 queries of 1024 positions, 3446 valid k-mers, nh = 5), on
    the mesh's column shards of it (W = 131: the 4-byte path; W = 128), on
    a server batch (64 queries, all 1024 k-mers valid) and at R = 2^26,
    W = 64 (offsets past 2^31 words). The note: the share of the function's
    byte bound (the rows the valid k-mers gather, idx, valid, the
    thresholds and the output, over 3.35 TB/s)."""
    main = torch.empty((1 << 22, 512), dtype=torch.int32, device=device).random_(
        -2**31, 2**31, generator=gen)
    yield from _search_shape("main", main, SEARCH_MAIN, gen)
    for w in (131, 128):
        yield from _search_shape(f"W={w} shard", main[:, :w].contiguous(), SEARCH_MAIN, gen)
    yield from _search_shape("server", main, [1024] * 64, gen)
    del main
    torch.cuda.empty_cache()
    wide = torch.empty((1 << 26, 64), dtype=torch.int32, device=device).random_(
        -2**31, 2**31, generator=gen)
    yield from _search_shape("R=2^26", wide, [1, 2, 256, 200], gen)


MURMUR_K = 31


def murmur_cases(device, gen):
    """murmur32 as slice indices, k = 31: the ingest's 2^23 distinct words
    at nh = 4, L = 21, and entry()'s 226 at nh = 5, L = 14. The note: the
    share of the function's bound (the larger of murmur_ops over the two
    pipes' issue limit and 8 bytes in and 4 * nh out a word over 3.35
    TB/s)."""
    for n, nh, L in ((1 << 23, 4, 21), (226, 5, 14)):
        words = torch.randint(0, 1 << 62, (n,), device=device, generator=gen)
        out = torch.empty((n, nh), dtype=torch.int32, device=device)
        ops = n * murmur_ops(MURMUR_K, nh)
        bound = max(ops / INT32_OPS_PER_S, (8 * n + 4 * n * nh) / HBM_BYTES_PER_S) * 1e3

        def call(lib, st, words=words, out=out, n=n, nh=nh, L=L):
            return lib.kw_murmur32(words.data_ptr(), out.data_ptr(), n, MURMUR_K, nh,
                                   (1 << L) - 1, st)
        yield Case(f"n={n} k={MURMUR_K} nh={nh} L={L}", call, [(out, -7)], 20, ops=ops,
                   note=lambda ms, bound=bound: f", {bound / ms:.3f} of the {bound:.3g} ms "
                                                "bound")


MERGE_K, MERGE_CAP = 31, 5      # the build's k and min_count (cap = min_count)
EARLIER_MERGE_TILE = 2048       # the tile of csrc/merge.cu before its merge and fold were one pass


def _distinct_words(n: int, gen, device) -> torch.Tensor:
    """n distinct sorted int64 k-mer words (k = 31): running sums of random
    gaps, about 2^62 / n apart."""
    gap = max(2, (1 << (2 * MERGE_K)) // max(n, 1))
    return torch.cumsum(torch.randint(1, gap, (n,), device=device, generator=gen), 0)


def _drawn_words(n: int, distinct: int, gen, device) -> torch.Tensor:
    """n sorted words drawn from a pool of ``distinct`` (a chunk's windows)."""
    pool = torch.randint(0, 1 << (2 * MERGE_K), (distinct,), device=device, generator=gen)
    pick = torch.randint(0, distinct, (n,), device=device, generator=gen)
    return torch.sort(pool[pick]).values


def _library_note(words):
    """torch.unique_consecutive(return_counts=True) timed once beside a
    run_counts case: it computes the kernel's function."""
    done = {}

    def note(ms):
        if "ms" not in done:
            call = lambda: torch.unique_consecutive(words, return_counts=True)  # noqa: E731
            call()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(3):
                call()
            end.record()
            end.synchronize()
            done["ms"] = start.elapsed_time(end) / 3
        return f"; torch.unique_consecutive {done['ms']:.4f} ms"
    return note


def _bound_note(nbytes_of_num, stats, extra=None):
    """The share of the byte bound, the bytes counted from this run's num
    (stats[0] after the launches)."""
    def note(ms):
        bound = nbytes_of_num(int(stats[0])) / HBM_BYTES_PER_S * 1e3
        return (f"{bound / ms:.3f} of the {bound:.4f} ms byte bound"
                + (extra(ms) if extra else ""))
    return note


def merge_cases(device, gen):
    """run_counts (the main path's call: cap = min_count = 5, the flags) and
    merge_counts at two shapes each. A 46 Mbp accession: its 36,799,920
    sorted valid windows with 6.7 M distinct, and the last of its 6 chunk
    merges (the runs of 5/6 and of 1/6 of its windows). A real accession's
    chunk at CHUNK_WINDOWS_MAX: 2^27 sorted windows, about half distinct;
    and an accumulator of 2^28 distinct words merged with a chunk's 2^26
    (half of them in the accumulator). Also run_counts with weights over
    the 46 Mbp merge's pairs, the fold the parent's merge_counts ends with.
    An earlier version's merge (one without kw_merge_scratch_words) is its
    merge kernel, then the run_counts fold
    of the merged pairs (the counts as weights). Each line ends with the
    share of the byte bound (8 bytes a position, 12 with weights, or 12 a
    pair, in; 13 a distinct word out) and, for run_counts,
    torch.unique_consecutive's time in the same run."""
    empty = lambda m, dtype=torch.int64: torch.empty(m, dtype=dtype, device=device)  # noqa: E731

    def run_case(label, words, weights=None):
        n = words.shape[0]
        outs = [(empty(n), -7), (empty(n, torch.int32), -7), (empty(n, torch.uint8), 9),
                (empty(2), -7)]
        scratch = torch.zeros(-(-n // EARLIER_MERGE_TILE) + 8, dtype=torch.int64, device=device)
        ptr = 0 if weights is None else weights.data_ptr()

        def call(lib, st):
            return lib.kw_run_counts(words.data_ptr(), ptr, *(t.data_ptr() for t, _ in outs),
                                     scratch.data_ptr(), n, MERGE_CAP, MERGE_CAP, st)
        per = 8 if weights is None else 12
        return Case(f"run_counts {label}: n={n}", call, outs, 10, graph=False,
                    note=_bound_note(lambda num: per * n + 13 * num, outs[3][0],
                                     _library_note(words) if weights is None else None))

    def merge_case(label, wa, ca, wb, cb):
        na, nb = wa.shape[0], wb.shape[0]
        n = na + nb
        outs = [(empty(n), -7), (empty(n, torch.int32), -7), (empty(n, torch.uint8), 9),
                (empty(2), -7)]
        tiles = -(-n // EARLIER_MERGE_TILE)
        scratch = torch.zeros(2 * tiles + 8, dtype=torch.int64, device=device)
        merged = (empty(n), empty(n, torch.int32))     # the parent's merged pairs
        run_scratch = torch.zeros(tiles + 1, dtype=torch.int64, device=device)
        ins = [t.data_ptr() for t in (wa, ca, wb, cb)]

        def call(lib, st):
            if hasattr(lib, "kw_merge_scratch_words"):
                return lib.kw_merge_counts(*ins, *(t.data_ptr() for t, _ in outs),
                                           scratch.data_ptr(), na, nb, MERGE_CAP, MERGE_CAP, st)
            return (lib.kw_merge_counts(*ins, merged[0].data_ptr(), merged[1].data_ptr(),
                                        scratch.data_ptr(), na, nb, st)
                    or lib.kw_run_counts(merged[0].data_ptr(), merged[1].data_ptr(),
                                         *(t.data_ptr() for t, _ in outs),
                                         run_scratch.data_ptr(), n, MERGE_CAP, MERGE_CAP, st))
        return Case(f"merge_counts {label}: na={na} nb={nb}", call, outs, 10, graph=False,
                    note=_bound_note(lambda num: 12 * n + 13 * num, outs[3][0]))

    from ..ops.counting import run_counts_ref

    n46, distinct46 = 36_799_920, 6_732_793
    words = _drawn_words(n46, distinct46, gen, device)
    yield run_case("a 46 Mbp accession's sorted valid windows", words)
    del words
    pool = torch.randint(0, 1 << (2 * MERGE_K), (distinct46,), device=device, generator=gen)

    def run_of(m):
        w, c, st, _ = run_counts_ref(torch.sort(pool[torch.randint(
            0, distinct46, (m,), device=device, generator=gen)]).values, None, MERGE_CAP)
        return w[: int(st[0])].clone(), c[: int(st[0])].clone()
    wa, ca = run_of(n46 - n46 // 6)
    wb, cb = run_of(n46 // 6)
    del pool
    yield merge_case("the last of a 46 Mbp accession's 6 chunk merges", wa, ca, wb, cb)
    joined, order = torch.sort(torch.cat([wa, wb]), stable=True)
    weights = torch.cat([ca, cb])[order]
    del wa, ca, wb, cb, order
    yield run_case("with weights (the parent merge's fold of those pairs)", joined, weights)
    del joined, weights
    torch.cuda.empty_cache()
    n = 1 << 27
    words = _drawn_words(n, n * 7 // 10, gen, device)
    yield run_case("a chunk at CHUNK_WINDOWS_MAX", words)
    del words
    torch.cuda.empty_cache()
    wa = _distinct_words(1 << 28, gen, device)
    shared = wa[torch.randint(0, wa.shape[0], (1 << 25,), device=device, generator=gen)]
    wb = torch.unique(torch.cat([shared, torch.randint(0, 1 << (2 * MERGE_K), (1 << 25,),
                                                       device=device, generator=gen)]))
    del shared
    ca = torch.randint(1, MERGE_CAP + 1, wa.shape, dtype=torch.int32, device=device,
                       generator=gen)
    cb = torch.randint(1, MERGE_CAP + 1, wb.shape, dtype=torch.int32, device=device,
                       generator=gen)
    yield merge_case("an accumulator of 2^28 words and a chunk's 2^26", wa, ca, wb, cb)


# Opcodes (before the first '.') by the pipe they issue to; IMAD's forms
# (IMAD.SHL, IMAD.MOV, IMAD.WIDE, IMAD.IADD) go to the FMA pipe.
ALU_OPS = {"LOP3", "SHF", "PRMT", "IADD3", "LEA", "ISETP", "SEL", "IABS", "IMNMX"}
FMA_OPS = {"IMAD", "IMUL"}


def sass_mix(so: str, kernel: str, instance: str) -> str:
    """The SASS of ``kernel`` in the library ``so`` (its ``instance``
    where it has several, a pattern of the mangled name): instructions by
    opcode, the ALU and FMA pipes' shares, and the ms the ALU pipe's alone
    take for 2^23 threads over one pipe's rate (each thread runs the body
    once at that size)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    opcode = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    funcs = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = opcode.findall(body)
    names = [f for f in funcs if kernel in f]
    if len(names) > 1:
        names = [f for f in names if re.search(instance, f)]
    if len(names) != 1:
        return f"{kernel} ({instance}): {len(names)} functions match"
    ops = collections.Counter(op.split(".")[0] for op in funcs[names[0]])
    alu = sum(v for k, v in ops.items() if k in ALU_OPS)
    fma = sum(v for k, v in ops.items() if k in FMA_OPS)
    return (f"{names[0]}: {sum(ops.values())} instructions, ALU pipe {alu}, FMA pipe {fma}; "
            f"ALU alone at 2^23: {alu * (1 << 23) / ONE_PIPE_OPS_PER_S * 1e3:.4f} ms; "
            + ", ".join(f"{k} {v}" for k, v in ops.most_common()))


# kernel -> (source in csrc/, its C entries, its cases)
KERNELS = {
    "kmers": ("kmers.cu", ("canonical_kmers", "canonical_kmers_ascii"), kmers_cases),
    "select_runs": ("counting.cu", ("select_runs",), select_runs_cases),
    "bit_transpose": ("bit_transpose.cu", ("bit_transpose",), bit_transpose_cases),
    "sort": ("sort.cu", ("radix_sort_hist", "radix_sort_pairs"), sort_cases),
    "bitset": ("bitset.cu", ("bloom_set_bits",), bitset_cases),
    "roof": (os.path.join("variants", "int_roof.cu"), ("int_roof",), roof_cases),
    "search": ("search.cu", ("search_complete", "search_counts", "search_total_hits"),
               search_cases),
    "murmur": ("murmur.cu", ("murmur32",), murmur_cases),
    "merge": ("merge.cu", ("run_counts", "merge_counts"), merge_cases),
}
# kernel -> (the kernel's name in the SASS, the instance to show)
SASS = {"murmur": ("murmur32_kernel", f"ILi{MURMUR_K}E(Li4E)?E")}


def sriracha_cases(device, rng):
    """(label, k, reads uint8 [B, L] and lengths int32 [B] on ``device``,
    the subjects) of ``time_kernel sriracha``: 150 bp reads
    (``bench.sriracha.read_block``) of 40 random 30 kbp genomes, reads of
    1.5 and 15 kbp, the wide batches of the 32768 bucket; and
    bench.sriracha's own inputs."""
    from ..bench.sriracha import make_inputs, read_block
    from ..core.words import canonical_kmers

    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = rng.integers(0, 4, size=(40, 30_000), dtype=np.uint8)

    def batch(B, L):
        b, lengths = read_block(rng, genomes, B, L, 150)
        return torch.from_numpy(b).to(device), torch.from_numpy(lengths).to(device)

    def wide(lengths):
        """A [len(lengths), 32768] batch: row r holds genome r's bases,
        repeated to its length; row 2 has 100 N bases past 5000."""
        b = np.zeros((len(lengths), 1 << 15), np.uint8)
        for r, n in enumerate(lengths):
            b[r, :n] = acgt[np.resize(genomes[r], n)]
        b[2, 5000:5100] = ord("N")
        return (torch.from_numpy(b).to(device),
                torch.tensor(lengths, dtype=torch.int32, device=device))

    for k in (11, 21):
        subj = [(f"s{i}", np.unique(canonical_kmers(acgt[g].tobytes(), k)))
                for i, g in enumerate(genomes)]
        yield f"[512, 256] k={k}", k, *batch(512, 256), subj
        yield f"[8192, 256] k={k}", k, *batch(8192, 256), subj
        for B, L, read_len in ((512, 2048, 1500), (64, 16384, 15000), (512, 16384, 15000)):
            b, lengths = read_block(rng, genomes, B, L, read_len)
            yield (f"[{B}, {L}] k={k} ({read_len} bp)", k, torch.from_numpy(b).to(device),
                   torch.from_numpy(lengths).to(device), subj)
        yield f"[4, 32768] k={k} (3 long reads)", k, *wide([1 << 15, 20_000, 20_000, 0]), subj
        edge = [0, k - 1, 16385, 16384 + k - 1, 16384 + k, 20_000, 26_000, 32_000]
        yield f"[8, 32768] k={k} (rows of {edge} bp)", k, *wide(edge), subj
    subj, reads = make_inputs(21, 128, 512, 2048)
    block = np.stack([np.frombuffer(r.encode("ascii"), np.uint8) for r in reads])
    yield ("[512, 128] k=21 (bench.sriracha)", 21, torch.from_numpy(block).to(device),
           torch.full((512,), 128, dtype=torch.int32, device=device), subj)


def sriracha_routes(reads, lengths, tables, want, others=()) -> tuple[dict, dict]:
    """Each route of one batch, run once into an output filled with -7 and
    held to ``want`` (``read_batch_counts_ref``'s), then timed in a CUDA
    graph in the order listed and back: "fused", the package library's
    fused entry (``sriracha.device.fused_kernel``'s; a batch of the fused
    route's width only), and "fused TAG", the same entry of each (TAG,
    library) of ``others`` that has it; "counts", the package library's
    ``sriracha_counts_*`` alone on the batch's canonical words (made once
    beforehand by canonical_kmers' ASCII entry), and "counts TAG", that
    entry of each other library; "words", canonical_kmers' ASCII entry and
    the package's ``sriracha_counts_*`` (the route of a wider batch). Raw
    launches: none is counted. Returns ({route: output equal}, {route:
    [ms, ms]})."""
    from . import get_lib
    from ..sriracha import device as tsr

    lib = get_lib()
    B, L = reads.shape
    k = tables.k
    out = torch.empty_like(want)
    words = torch.empty((B, L - k + 1), dtype=torch.int64, device=reads.device)
    valid = torch.empty((B, L - k + 1), dtype=torch.bool, device=reads.device)
    stream = torch.cuda.current_stream().cuda_stream
    if lib.kw_canonical_kmers_ascii(reads.data_ptr(), words.data_ptr(), valid.data_ptr(),
                                    B, L, L, k, stream):
        raise RuntimeError("canonical_kmers_ascii: launch failed")
    scratch = tsr.counts_scratch(B, L - k + 1, reads.device)

    def raw(launch, library=lib):
        return lambda st: getattr(library, "kw_" + launch[0])(*launch[1:-1], st)

    versions = {}
    if tsr.fused_route(L, k):
        fused = tsr.reads_launch(reads, lengths, tables, out)
        versions["fused"] = raw(fused)
        for tag, other in others:
            if hasattr(other, "kw_" + fused[0]):   # an earlier source may lack the entry
                versions[f"fused {tag}"] = raw(fused, other)
    counts = tsr.counts_launch(words, valid, lengths, tables, out, scratch)
    versions["counts"] = raw(counts)
    for tag, other in others:
        if hasattr(other, "kw_" + counts[0]):
            versions[f"counts {tag}"] = raw(counts, other)
    versions["words"] = lambda st: (
        lib.kw_canonical_kmers_ascii(reads.data_ptr(), words.data_ptr(), valid.data_ptr(),
                                     B, L, L, k, st) or versions["counts"](st))
    same = {}
    for name, call in versions.items():
        out.fill_(-7)
        if call(stream):
            raise RuntimeError(f"sriracha route {name}: launch failed")
        torch.cuda.synchronize()
        same[name] = torch.equal(out, want)
    names = list(versions)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(versions[name], 20))
    return same, times


def fused_report(log: str) -> str:
    """nvcc's registers and spills of the sriracha_reads_kernel (E: slots a
    lane) and sriracha_block_kernel (its source, log2 P) instances in a
    build's report, one line an instance."""
    out = []
    for part in re.split(r"(?=ptxas info\s*: Compiling entry function)", log):
        head = re.match(r"ptxas info\s*: Compiling entry function '(\S+)'", part)
        kernel = head and re.search(r"sriracha_(reads|block)_kernel", head.group(1))
        if kernel:
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            inst = re.search(r"(Lut|Hash)ProbeE([jy])Li(\d+)E", head.group(1))
            source = re.search(r"(Ascii|Words)Source", head.group(1))
            param = "E" if kernel[1] == "reads" else "log2 P"
            name = f"{kernel[1]} {source[1].lower()}" if source else kernel[1]
            out.append((f"{name} {inst[1].lower()} {'u32' if inst[2] == 'j' else 'u64'} "
                        f"{param}={inst[3]}" if inst else head.group(1)) + " "
                       f"{regs.group(1) if regs else '?'} regs "
                       f"{spill.group(1) if spill else '?'} B spilled")
    return "; ".join(out)


def sriracha_main(others: list[str]) -> int:
    """``time_kernel sriracha [other_sriracha.cu ...]``: ``sriracha_routes``
    over ``sriracha_cases``, each other source compiled alone (module
    docstring)."""
    from . import build
    from ..bench.sriracha import counts_work, reads_work
    from ..ops import kmers as tk
    from ..sriracha import device as tsr

    so = build()
    with open(so[:-3] + ".log") as f:
        print("fused kernel instances: " + fused_report(f.read()), flush=True)
    alone = []
    for source in others:
        path, report = build_alone(source)
        if report is not None:
            print(f"{source}: " + fused_report(report), flush=True)
        other = ctypes.CDLL(path)
        for name in ("sriracha_reads_lut", "sriracha_reads_hash", "sriracha_block_lut",
                     "sriracha_block_hash", "sriracha_counts_lut", "sriracha_counts_hash"):
            if hasattr(other, "kw_" + name):
                getattr(other, "kw_" + name).argtypes = _ENTRIES[name]
                getattr(other, "kw_" + name).restype = ctypes.c_int
        alone.append((source, other))   # the path as named: two may share a file name
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())

    def bound(nbytes, nops):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / INT32_OPS_PER_S * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    for label, k, reads, lengths, subj in sriracha_cases(device, np.random.default_rng(0)):
        routes = [tsr.build_hash_tables(subj, k, device)]
        if k <= tsr.MAX_TABLE_K:
            routes.insert(0, tsr.build_lut_tables(subj, k, device))
        words, valid = tk.canonical_kmers_ascii_ref(reads, k)
        for tables in routes:
            want = tsr.read_batch_counts_ref(reads, lengths, tables)
            same, times = sriracha_routes(reads, lengths, tables, want, alone)
            fused_ms, fused_by = bound(*reads_work(reads, lengths, tables))
            counts_ms, counts_by = bound(*counts_work(words, valid, lengths, tables))
            distinct = int(want[:, tables.ns + 1].sum())
            print(f"sriracha {label} {tables.route} ({tables.ns} subjects, {distinct} distinct "
                  f"words; bound from ASCII {fused_ms:.5f} ms by {fused_by}, of the counts "
                  f"{counts_ms:.5f} ms by {counts_by}): " + "; ".join(
                      f"{name} {t[0]:.4f} / {t[1]:.4f} ms (share "
                      f"{(counts_ms if name.startswith('counts') else fused_ms) / min(t):.3f})"
                      for name, t in times.items()) + f"; outputs equal: {same}", flush=True)
            if not all(same.values()):
                return 1
        del words, valid
        torch.cuda.empty_cache()
    return 0


def main(argv: list[str]) -> int:
    if argv and argv[0] == "sriracha":
        return sriracha_main(argv[1:])
    if not argv or argv[0] not in KERNELS:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        print(f"KERNEL is one of {', '.join(KERNELS)} or sriracha", file=sys.stderr)
        return 2
    source, entries, cases = KERNELS[argv[0]]
    sources = [os.path.join(CSRC_DIR, source), *argv[1:]]
    libs = [load(s, entries) for s in sources]
    if argv[0] in SASS:
        for lib in libs:
            print(sass_mix(lib._name, *SASS[argv[0]]), flush=True)
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for case in cases(device, gen):
        results = []
        for lib in libs:
            for t, fill in case.outputs:
                t.fill_(fill)
            if case.call(lib, stream):
                raise RuntimeError("launch failed")
            results.append([t.clone() for t in case.result(lib)] if case.result else
                           [t.clone() for t, _ in case.outputs])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for r in results[1:] for a, b in zip(r, results[0]))
        del results
        order = list(range(len(libs))) + list(reversed(range(len(libs))))
        times = [[] for _ in libs]
        for i in order:
            times[i].append(cuda_ms(lambda st, lib=libs[i]: case.call(lib, st), case.reps,
                                    case.graph))
        def rate(t):
            text = (f"{case.ops / t / 1e9:.3f} T ops/s" if case.ops else "") + (
                case.note(t) if case.note else "")
            return f" ({text})" if text else ""
        print(f"{argv[0]} {case.label}: " + "; ".join(
            f"{os.path.basename(s)} {t[0]:.4f} / {t[1]:.4f} ms{rate(min(t))}"
            for s, t in zip(sources, times)) + f"; outputs equal: {same}", flush=True)
        if not same:
            return 1
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
