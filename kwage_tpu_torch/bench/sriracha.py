"""SriRachA's device path: the port's counterpart of
``tools/bench_sriracha_device.py``.

    python3 -m kwage_tpu_torch.bench.sriracha [k] [read_len] [n_reads] [path] [subj_kmers]

Defaults: k=21, read_len 128, n_reads 65536, path auto, subj_kmers 2048.
The JAX tool's seeded inputs (``make_inputs``): 4 subjects of about
subj_kmers k-mers each and n_reads random reads. End to end: the port's
``search_reads_device`` over one warm-up span of 16 x 512 reads (its wall
is ``warmup_compile_s``), then over the rest of the stream, timed (host
packing, uploads and readbacks included: ``value``, Mbp/s).

Kernel only: the launches the path makes on one [512, read_len] block of
the reads (the reads repeat when there are fewer than 512): one
``sriracha_reads_{hash,lut}`` where the block has at most 512 windows a
row, one ``sriracha_block_{hash,lut}`` where it has at most 2^14
(``sriracha.device.fused_route``, ``fused_kernel``), else
``canonical_kmers`` and ``sriracha_counts_{hash,lut}``; timed with CUDA events over a CUDA graph
of raw launches that cycles RING copies of the block, each rolled by one
more row: the counterpart of the JAX tool's chained ``jnp.roll``
(``kernel_only_mbps``). The two-launch step is timed the same way beside
it (``kernel_only_mbps_words``), so the two routes are compared in one
run. ``path`` picks the subject tables: ``lut``, ``hash``, or ``auto``, the
port's own router (``sriracha.device.use_lut``). On the CPU the plain
versions run, timed by the host clock.

The last line has the JAX tool's keys (and ``kernel_only_mbps_words``);
``platform`` is the torch device type and the device's name goes on an
earlier line.
"""

from __future__ import annotations

import itertools
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..kernels.time_kernel import cuda_ms
from ..ops import kmers as tk
from ..sriracha import device as tsr
from ..sriracha.engine import SrirachaOptions, canonical_kmers
from ._common import bench_device, check, print_device

BATCH = 512
SPAN = 16 * BATCH
RING = 8
SAMPLES = 5
REPLAYS = 5


def make_reads(n: int, read_len: int, rng: np.random.Generator) -> list[str]:
    bases = np.array(list("ACGT"))
    arr = rng.integers(0, 4, size=(n, read_len))
    return ["".join(bases[row]) for row in arr]


def make_inputs(k: int, read_len: int, n_reads: int, subj_kmers: int, seed: int = 7):
    """The JAX tool's inputs: 4 subjects (name, sorted distinct canonical
    k-mers) of a random sequence of subj_kmers + k - 1 bases each, then
    n_reads random reads, from one generator in that order."""
    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    subjects = []
    for i in range(4):
        seq = "".join(bases[rng.integers(0, 4, size=subj_kmers + k - 1)])
        subjects.append((f"subject{i}", np.unique(canonical_kmers(seq, k))))
    return subjects, make_reads(n_reads, read_len, rng)


def read_block(rng: np.random.Generator, genomes: np.ndarray, B: int, L: int, read_len: int,
               sub_rate: float = 0.01) -> tuple[np.ndarray, np.ndarray]:
    """ASCII reads uint8 [B, L] of ``read_len`` random bases (zero padding
    after), every fifth drawn from ``genomes`` (codes uint8 [n, bp]) with
    ``sub_rate`` substitutions a base, on a random strand, and one base in
    1000 an N; the lengths int32 [B], the last 3 rows empty (batch padding)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    b = np.zeros((B, L), np.uint8)
    b[:, :read_len] = acgt[rng.integers(0, 4, size=(B, read_len))]
    for r in range(0, B, 5):
        g = genomes[int(rng.integers(0, genomes.shape[0]))]
        a = int(rng.integers(0, g.shape[0] - read_len + 1))
        codes = g[a : a + read_len].copy()
        sub = rng.random(read_len) < sub_rate
        codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) % 4
        b[r, :read_len] = acgt[3 - codes[::-1] if rng.random() < 0.5 else codes]
    b[:, :read_len][rng.random((B, read_len)) < 0.001] = ord("N")
    lengths = np.full(B, read_len, np.int32)
    lengths[-3:] = 0
    b[-3:] = 0
    return b, lengths


SECTOR = 32  # bytes: the card's smallest memory transaction


def table_bytes(words: torch.Tensor, tables) -> int:
    """The subject-table bytes that probing ``words`` (every read's distinct
    valid words, flattened) in every group must move. A LUT: 4 bytes a
    probe. A hash table: one 32-byte sector of keys a probe (a bucket's
    first four slots; ``build_hash_group`` leaves about one key a row, so a
    miss meets an empty slot there) and one 32-byte sector of masks a hit.
    Each group's count is capped at its table's bytes, read once."""
    total = 0
    for g in range(-(-tables.ns // tsr.GROUP)):
        if tables.route == "lut":
            need, whole = 4 * words.numel(), 4 * tables.table.shape[1]
        else:
            hits = int(tsr.probe_ref(tables, g, words).count_nonzero())
            need = SECTOR * (words.numel() + hits)
            whole = ((int(tables.bmask[g]) + 1) * tsr.BUCKET_CAP
                     * (tables.keys.element_size() + tables.masks.element_size()))
        total += min(need, whole)
    return total


def probe_work(words: torch.Tensor, valid: torch.Tensor, lengths: torch.Tensor,
               tables) -> tuple[int, int]:
    """(table bytes, operations) of counting a batch's windows (int64 words
    and validity [B, nwin]): ``table_bytes`` of every read's distinct valid
    words, and a merge sort's n log2 n compare-exchanges of 3 operations
    and 3 a word to dedup and probe, n a read's valid words."""
    s, distinct, nk, _ = tsr.dedup_ref(words, valid, lengths, tables.k)
    n = nk.double().cpu()
    nops = int((3 * n * torch.log2(n.clamp(min=2)).ceil() + 3 * n).sum())
    return table_bytes(s[distinct], tables), nops


def counts_work(words: torch.Tensor, valid: torch.Tensor, lengths: torch.Tensor,
                tables) -> tuple[int, int]:
    """(bytes, operations) of the function of one sriracha_counts launch on
    canonical words int64 and validity [B, nwin]: the word and flag of
    every window that fits its read (the rest are never read), the lengths
    and the counts once, and ``probe_work``'s."""
    B, nwin = words.shape
    fit = int((lengths.long() - tables.k + 1).clamp(0, nwin).sum())
    nbytes, nops = probe_work(words, valid, lengths, tables)
    return (nbytes + fit * (words.element_size() + valid.element_size()) + 4 * B
            + 4 * B * (tables.ns + 2), nops)


def reads_work(reads: torch.Tensor, lengths: torch.Tensor, tables) -> tuple[int, int]:
    """(bytes, operations) of the function of one fused launch
    (sriracha_reads or sriracha_block) on ASCII reads uint8 [B, L]: the reads, the lengths and the counts once,
    and ``probe_work``'s table bytes; 8 operations a base to decode, 20 a
    window for its canonical word, and ``probe_work``'s."""
    B, L = reads.shape
    k = tables.k
    words, valid = tk.canonical_kmers_ascii_ref(reads, k)
    nbytes, nops = probe_work(words, valid, lengths, tables)
    lens = lengths.long().clamp(0, L)
    return (nbytes + reads.numel() + 4 * B + 4 * B * (tables.ns + 2),
            nops + 8 * int(lens.sum()) + 20 * int((lens - k + 1).clamp(min=0).sum()))


def kernel_ms(block: torch.Tensor, lengths: torch.Tensor, tables, words: bool = False) -> float:
    """ms of one step on a [512, read_len] block: the path's launches (one
    fused launch where ``fused_route``), or with ``words`` the
    canonical_kmers and sriracha_counts launches. On a card the median of
    SAMPLES readings, each the mean of REPLAYS replays of a CUDA graph of
    raw launches cycling RING blocks rolled a row apart; on the CPU the
    median of SAMPLES host-clock passes of the plain versions over the same
    blocks."""
    k = tables.k
    ring = [torch.roll(block, i, dims=0).contiguous() for i in range(RING)]
    if block.device.type != "cuda":
        def one_pass() -> float:
            t0 = time.perf_counter()
            for b in ring:
                if words:
                    w, v = tk.canonical_kmers(b, k)
                    tsr.sriracha_counts(w, v, lengths, tables)
                else:
                    tsr.read_batch_counts(b, lengths, tables)
            return (time.perf_counter() - t0) * 1e3 / RING

        return statistics.median(one_pass() for _ in range(SAMPLES))
    B, L = block.shape
    nwin = L - k + 1
    out = torch.empty((B, tables.ns + 2), dtype=torch.int32, device=block.device)
    turn = itertools.count()
    if words or not tsr.fused_route(L, k):
        wds = [torch.empty((B, nwin), dtype=torch.int64, device=block.device) for _ in ring]
        valid = [torch.empty((B, nwin), dtype=torch.bool, device=block.device) for _ in ring]
        scratch = tsr.counts_scratch(B, nwin, block.device)

        def call(stream):
            j = next(turn) % RING
            kernels.launch("canonical_kmers_ascii", ring[j].data_ptr(), wds[j].data_ptr(),
                           valid[j].data_ptr(), B, L, L, k, stream)
            launch = tsr.counts_launch(wds[j], valid[j], lengths, tables, out, scratch)
            kernels.launch(*launch[:-1], stream)
    else:
        def call(stream):
            launch = tsr.reads_launch(ring[next(turn) % RING], lengths, tables, out)
            kernels.launch(*launch[:-1], stream)

    with torch.cuda.device(block.device):
        return statistics.median(cuda_ms(call, REPLAYS) for _ in range(SAMPLES))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    k = int(argv[0]) if len(argv) > 0 else 21
    read_len = int(argv[1]) if len(argv) > 1 else 128
    n_reads = int(argv[2]) if len(argv) > 2 else 65536
    path = argv[3] if len(argv) > 3 else "auto"
    subj_kmers = int(argv[4]) if len(argv) > 4 else 2048
    check(path in ("auto", "lut", "hash"), f"path must be auto, lut or hash, not {path}")
    check(n_reads >= 1 and read_len >= k, "need at least one read of at least k bases")
    device = bench_device()
    print_device(device)

    subjects, reads = make_inputs(k, read_len, n_reads, subj_kmers)
    opt = SrirachaOptions(kmer_len=k)
    stream = [(seq, i, 0) for i, seq in enumerate(reads)]

    # Warm-up: one span pays the first launches and allocations of this
    # (k, padded length) shape.
    t0 = time.time()
    tsr.search_reads_device(stream[:SPAN], subjects, opt, batch_size=BATCH, span_reads=SPAN)
    warm_s = time.time() - t0

    timed = stream[SPAN:]
    t0 = time.time()
    res = tsr.search_reads_device(timed, subjects, opt, batch_size=BATCH, span_reads=SPAN)
    dt = time.time() - t0
    mbps = len(timed) * read_len / dt / 1e6

    block = np.stack([np.frombuffer(reads[r % n_reads].encode("ascii"), dtype=np.uint8)
                      for r in range(BATCH)])
    block_d = torch.from_numpy(block).to(device)
    lengths = torch.full((BATCH,), read_len, dtype=torch.int32, device=device)
    use_lut = tsr.use_lut(subjects, k, device) if path == "auto" else path == "lut"
    tables = (tsr.build_lut_tables if use_lut else tsr.build_hash_tables)(subjects, k, device)
    step_ms = kernel_ms(block_d, lengths, tables)
    words_ms = kernel_ms(block_d, lengths, tables, words=True)

    print(json.dumps({
        "metric": "sriracha_device_mbps",
        "kernel_only_mbps": BATCH * read_len / (step_ms * 1e-3) / 1e6,
        "kernel_only_mbps_words": BATCH * read_len / (words_ms * 1e-3) / 1e6,
        "k": k,
        "read_len": read_len,
        "reads_timed": len(timed),
        "value": mbps,
        "unit": "Mbp/s",
        "warmup_compile_s": warm_s,
        "timed_s": dt,
        "matches": sum(len(r) for r in res),
        "platform": device.type,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
