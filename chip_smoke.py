#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (kwage_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Search (phases 1-3): the reference's quota file shape, 2048 Bloom
filters per .db (k=31, 5 hashes) at L=22, so one .db is 1 GiB; 8 copies of
it fuse to W=512 words, 8 GiB on the device (the bench's fused shape).
Ingest (phase 6): 16 FASTQ accessions, 176 Mbp of 150 bp reads. SriRachA
(phase 8): 40 query genomes of 30 kbp against one FASTQ of 1,000,000
150 bp reads and 64 of 20 kbp. Everything is made from ``--seed``. Phases,
one line each; any failure raises and exits non-zero:

1. build   -- 2048 .bloom files (random bits at ~50% fill; a few filters
              also hold every k-mer of a planted sequence) packed to .db by
              the port's device transpose; its sha256 must equal the host
              builder's.
2. search  -- the port's ``kwage --device`` over the fused copies with 64
              queries, at -t 1.0 and -t 0.5: output bytes must equal the
              host engine's, and the hits must be exactly the planted ones.
3. serve   -- the port's SearchServer(engine="device") answers the same
              requests over loopback; the bytes must equal phase 2's.
              Phase 2 also prints the step times of one device search call
              (read, upload, search, hit lists).
6. ingest  -- the port's ``kwage-maestro-torch --device-build
              --device-transpose`` over 14 accessions of a 400 kbp genome at
              15x (fused batch) and 2 of a 4.6 Mbp genome at 10x (chunked),
              k=31, min count 5: every .bloom equals the exact host ground
              truth, every .db the host pack, a ``kwage --device`` search of
              genome reads the host engine's bytes; the golden corpus
              reproduces the golden .db digests.
7. entry   -- the port's ``entry()`` forward on the card equals the plain
              versions' result on the CPU.
8. sriracha -- ``kwage-sriracha-torch --device`` twice: (A) k=21, the
              bucketed hash tables, and (B) k=11, the dense LUTs (two
              groups of 32 + 8 subjects, ~1.2 M subject k-mers), t=0.8,
              --max-results 100: each TSV must equal the host engine's
              (the same CLI without ``--device``, one thread) byte for byte, and
              the subjects hit only by 20 kbp reads must list exactly those.
              Mbp/s, the device path's profile and the host's Mbp/s.
4. kernels -- every kernel against its plain PyTorch version on the card,
              bit for bit, at the paths' shapes and at R*W > 2^31 words
              (search) and num_acc * 2^L >= 2^32 bits (bloom_set_bits);
              CUDA-event times of both. The ingest kernels also at
              k = 15, 16, 31 and 32 on a small block, packed and ASCII, and
              canonical_kmers at k = 1-32 on lengths that end inside a word.
              The SriRachA kernels at phase 8's batch shape (512 x 256,
              k = 11 and 21), on a small block holding every byte value at
              k = 3, 13, 14, 16, 31, 32, on 2^15-base reads in batches of 4
              and 512 rows (canonical_kmers' ASCII entry too, at these
              three shapes), and on rows around the 2^14-word tile; both
              probes timed at 8 k, 64 k, 256 k and 1 M k-mers per group
              (k = 11): the LUT / hash crossover.
5. counts  -- every kernel was launched by the path phases (1-3, 6, 7, 8);
              each path's counts are zeroed just before it and read just
              after.

It ends with one JSON line a kernel (its shape on the main path, its time
beside its bound, its launches on each path), the card's name and power
limit, one JSON line of kernels and the line {"ok": true, "device": {...}}.
Without a CUDA device it exits 1. The kernels (nvcc, kwage_tpu_torch/csrc)
and the host library (g++, kwage_tpu_torch/native) build into
build/kwage_tpu_torch/. Nothing of kwage_tpu or jax is imported: the host
references are the port's own host engines and tests/golden.

``--profile`` runs phases 6 and 8 alone, with their checks, and breaks
down the kwage-maestro-torch call and each kwage-sriracha-torch --device
call: host-clock time per step (each step function of the port's
make_bloom and maestro modules, or the subject load, the table build, the
TSV rendering and the read iterator of SriRachA, with a device
synchronize after each) and, from torch.profiler, the device's busy time
per kernel or copy and its idle share of the call. It prints no result
line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import csv
import functools
import hashlib
import io
import json
import os
import socket
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kwage_tpu_torch import kernels
from kwage_tpu_torch.cli import sriracha as torch_sriracha_cli
from kwage_tpu_torch.cli.kwage import main as torch_kwage_main
from kwage_tpu_torch.cli.maestro import main as torch_maestro_main
from kwage_tpu_torch.cli.sriracha import main as torch_sriracha_main
from kwage_tpu_torch.core import FilterInfo, accession_to_str, str_to_accession
from kwage_tpu_torch.core.params import BloomParam, optimal_bloom_param
from kwage_tpu_torch.core.words import canonical_kmers
from kwage_tpu_torch.entry import entry
from kwage_tpu_torch.io.bloom_file import BloomFilterRecord, read_bloom_file, write_bloom_file
from kwage_tpu_torch.io.dbz_file import open_database
from kwage_tpu_torch.io.inventory import write_inventory
from kwage_tpu_torch.io.status import read_status_file
from kwage_tpu_torch.native import available as native_available
from kwage_tpu_torch.native import canonical_kmers_native, murmur32_native
from kwage_tpu_torch.ops import counting as tcount
from kwage_tpu_torch.ops import hashing as th
from kwage_tpu_torch.ops import kmers as tk
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.ops import transpose as tt
from kwage_tpu_torch.parallel import maestro as torch_maestro
from kwage_tpu_torch.parallel.maestro import (
    STATUS_DATABASE_SUCCESS,
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
)
from kwage_tpu_torch.pipeline import make_bloom as torch_make_bloom
from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files
from kwage_tpu_torch.pipeline.make_bloom import BuildOptions, build_bloom_from_file
from kwage_tpu_torch.search.resident import SearchServer
from kwage_tpu_torch.sriracha import device as tsr
from kwage_tpu_torch.utils.runtime import card_identity, resolve_device

NUM_FILTER = 2048          # the reference's quota file (options.h:137-157)
LOG2_FILTER_LEN = 22
KMER_LEN = 31
NUM_HASH = 5
COPIES = 8                 # fused .db copies in phases 2-3 (bench.py:42-47)
N_PLANTED = 16             # planted sequences, each held by 3 filters
CASES = [(1.0, "csv"), (0.5, "csv"), (0.5, "json")]  # (threshold, format)
# The ingest (phase 6): k=31, min count 5, p=0.25 and L 18-32 (defaults).
INGEST_K = 31
MIN_COUNT = 5
READ_LEN = 150
SUB_RATE = 0.002           # substitutions per base
N_RATE = 0.001             # N calls per base
# (genome bp, coverage, accessions): 14 x 6 Mbp through the fused batch,
# 2 x 46 Mbp (above the 8 Mbp chunk_bp) through the chunked builder.
INGEST = [(400_000, 15, 14), (4_600_000, 10, 2)]
# Phase 8, SriRachA: 40 query genomes of 30 kbp (SARS-CoV-2-sized) against
# one Illumina run of 1,000,000 reads of 150 bp, plus 64 reads of 20 kbp.
SR_SUBJECTS, SR_SUBJECT_BP = 40, 30_000
SR_READS, SR_LONG, SR_LONG_BP = 1_000_000, 64, 20_000
SR_LONG_ONLY = 4           # the last 4 subjects: hit by 20 kbp reads only
# (run, k, threshold, reads): (A) the bucketed hash tables, (B) the LUTs.
SR_RUNS = [("A", 21, 0.8, SR_READS), ("B", 11, 0.8, SR_READS)]
# Paths (each driven with the launch counts zeroed just before it) and
# the kernels each must launch.
PATH_KERNELS = {
    "search": ("bit_transpose", "search_complete", "search_counts"),
    "ingest": ("canonical_kmers", "select_runs", "bloom_set_bits", "bit_transpose",
               "search_complete", "search_counts"),
    "entry": ("canonical_kmers", "murmur32", "search_counts"),
    "sriracha": ("canonical_kmers", "sriracha_counts_lut", "sriracha_counts_hash",
                 "subject_table"),
}
# The TPU kernel each CUDA kernel replaces.
REPLACES = {
    "bit_transpose": "kwage_tpu/ops/transpose.py:101",
    "search_complete": "kwage_tpu/ops/search.py:88",
    "search_counts": "kwage_tpu/ops/search.py:136",
    "canonical_kmers": "kwage_tpu/ops/kmers.py:67",
    "murmur32": "kwage_tpu/ops/hashing.py:59",
    "select_runs": "kwage_tpu/ops/counting.py:206",
    "bloom_set_bits": "tools/exp_pallas_bitset.py:76",
    "sriracha_counts_lut": "kwage_tpu/sriracha/device.py:239",
    "sriracha_counts_hash": "kwage_tpu/sriracha/device.py:179",
    "subject_table": "kwage_tpu/sriracha/device.py:216",
}
SOURCES = {
    "bit_transpose": "kwage_tpu_torch/csrc/bit_transpose.cu",
    "search_complete": "kwage_tpu_torch/csrc/search.cu",
    "search_counts": "kwage_tpu_torch/csrc/search.cu",
    "canonical_kmers": "kwage_tpu_torch/csrc/kmers.cu",
    "murmur32": "kwage_tpu_torch/csrc/murmur.cu",
    "select_runs": "kwage_tpu_torch/csrc/counting.cu",
    "bloom_set_bits": "kwage_tpu_torch/csrc/bitset.cu",
    "sriracha_counts_lut": "kwage_tpu_torch/csrc/sriracha.cu",
    "sriracha_counts_hash": "kwage_tpu_torch/csrc/sriracha.cu",
    "subject_table": "kwage_tpu_torch/csrc/sriracha.cu",
}
# The card's published peaks (NVIDIA H100 SXM data sheet): 3.35 TB/s of HBM3;
# 67 TFLOP/s of float32 outside the tensor cores is 2 flops on each of 128
# lanes a clock and SM, and an SM has 64 int32 lanes of one operation each,
# so a quarter of that number in integer operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden", "e2e")
GOLDEN_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def accession(i: int) -> str:
    return f"SRR{1000000 + i}"


# --- data -------------------------------------------------------------------

def make_queries(rng, n_filter: int):
    """Planted sequences, the 3 filters holding each, and 64 queries as
    (sequence, planted index or None, fully planted)."""
    def seq(n):
        return "".join(rng.choice(list("ACGT"), size=int(n)))

    revcomp = str.maketrans("ACGT", "TGCA")
    planted = [seq(n) for n in rng.integers(80, 420, size=N_PLANTED)]
    holders = rng.choice(n_filter, size=(N_PLANTED, 3), replace=False)
    queries = []
    for j, s in enumerate(planted):
        queries.append((s, j, True))
        # ~62% of the k-mers planted: hits at -t 0.5, none at -t 1.0.
        queries.append((s + seq((len(s) - KMER_LEN + 1) * 0.6), j, False))
    for j in range(4):  # reverse complements: the same canonical k-mers
        queries.append((planted[j][::-1].translate(revcomp), j, True))
    queries += [(seq(n), None, False) for n in rng.integers(100, 700, size=24)]
    queries += [(seq(20), None, False), ("ACGTN" * 30, None, False),
                (seq(60) + "N" + seq(60), None, False), ("N" * 64, None, False)]
    return planted, holders, queries


def write_blooms(work: str, rng, n_filter: int, param: BloomParam,
                 planted, holders) -> list[str]:
    """One .bloom per filter: random bytes (~50% of bits set) plus, in the
    holders of each planted sequence, every bit its k-mers hash to."""
    mask = np.uint32(param.filter_len - 1)
    extra = collections.defaultdict(list)
    for j, s in enumerate(planted):
        kmers = np.unique(canonical_kmers(s, KMER_LEN))
        pos = (murmur32_native(kmers, KMER_LEN, NUM_HASH) & mask).reshape(-1)
        for f in holders[j]:
            extra[int(f)].append(pos.astype(np.int64))
    paths = []
    for i in range(n_filter):
        bits = rng.integers(0, 256, size=param.filter_len // 8, dtype=np.uint8)
        for pos in extra.get(i, ()):
            np.bitwise_or.at(bits, pos >> 3, (1 << (pos & 7)).astype(np.uint8))
        rec = BloomFilterRecord(
            param=param, crc32=zlib.crc32(bits.tobytes()) & 0xFFFFFFFF,
            info=FilterInfo(run_accession=str_to_accession(accession(i))), bits=bits)
        paths.append(os.path.join(work, f"{accession(i)}.bloom"))
        write_bloom_file(paths[-1], rec)
    return paths


def expected_hits(queries, holders, threshold: float, copies: int) -> collections.Counter:
    """(query id, accession) -> rows expected in the CSV output."""
    want = collections.Counter()
    for qi, (_, j, full) in enumerate(queries):
        if j is not None and (full or threshold < 1.0):
            for f in holders[j]:
                want[(f"command line seq {qi}", accession(int(f)))] += copies
    return want


def csv_hits(text: str) -> collections.Counter:
    rows = list(csv.reader(io.StringIO(text)))[1:]
    return collections.Counter((r[0], r[4]) for r in rows)


# --- phases 1-3: the main path -------------------------------------------------

def run_main_path(work: str, device: torch.device, n_filter: int, log2_len: int,
                  copies: int, seed: int) -> dict:
    """Phases 1-3 through the port's entry points; returns phase 2's
    outputs keyed by case. Runs on any torch device (on the CPU with the
    plain versions; the card is where it counts)."""
    rng = np.random.default_rng(seed)
    param = BloomParam(kmer_len=KMER_LEN, log_2_filter_len=log2_len, num_hash=NUM_HASH)
    planted, holders, queries = make_queries(rng, n_filter)
    t0 = time.perf_counter()
    blooms = write_blooms(work, rng, n_filter, param, planted, holders)
    t_blooms = time.perf_counter() - t0

    # Phase 1: the pack through the device transpose vs the host builder.
    dev_db, host_db = os.path.join(work, "sra.0.db"), os.path.join(work, "host.db")
    t0 = time.perf_counter()
    build_db_from_bloom_files(dev_db, param, blooms, device=device)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_db_from_bloom_files(host_db, param, blooms)
    t_host = time.perf_counter() - t0
    digest = sha256(dev_db)
    check(digest == sha256(host_db), "device-packed .db differs from the host builder's")
    os.remove(host_db)
    db_bytes = os.path.getsize(dev_db)
    print(f"phase 1 build: {n_filter} filters L={log2_len} -> {db_bytes} B .db, "
          f"sha256 {digest[:16]} == host; blooms {t_blooms:.2f} s, device pack "
          f"{t_dev:.2f} s ({db_bytes / t_dev / 1e9:.3f} GB/s), host pack {t_host:.2f} s",
          flush=True)

    # Phase 2: kwage --device over the fused copies vs the host engine.
    files = [dev_db]
    for i in range(1, copies):
        files.append(os.path.join(work, f"sra.{i}.db"))
        os.link(dev_db, files[-1])
    seqs = [q for q, _, _ in queries]
    base = [a for f in files for a in ("-d", f)]
    outputs, times = {}, []
    for threshold, fmt in CASES:
        got = {}
        for name, main, extra in (("device", torch_kwage_main, ["--device"]),
                                  ("host", torch_kwage_main, [])):
            out = os.path.join(work, f"{name}.out")
            t0 = time.perf_counter()
            rc = main(base + ["-t", str(threshold), f"--o.{fmt}", "-o", out] + extra + seqs)
            times.append(f"{name} t={threshold} {fmt} {time.perf_counter() - t0:.2f} s")
            check(rc == 0, f"{name} kwage exited {rc}")
            with open(out) as f:
                got[name] = f.read()
        check(got["device"] == got["host"],
              f"--device output differs from the host engine at -t {threshold} {fmt}")
        if fmt == "csv":
            check(csv_hits(got["device"]) == expected_hits(queries, holders, threshold, copies),
                  f"hits at -t {threshold} are not exactly the planted ones")
        outputs[(threshold, fmt)] = got["device"]
    n_hits = sum(expected_hits(queries, holders, 0.5, copies).values())
    steps: dict = {}
    t0 = time.perf_counter()
    ts.search_files_device(files, list(enumerate(seqs)), 0.5, device, profile=steps)
    t_call = time.perf_counter() - t0
    print(f"phase 2 search: {len(queries)} queries x {copies} fused files "
          f"(W={copies * ((n_filter + 31) // 32)}), bytes == host engine, "
          f"{n_hits} planted hits at -t 0.5; {'; '.join(times)}; steps of one device "
          f"search call ({t_call:.3f} s): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()), flush=True)

    # Phase 3: the resident server answers the same requests.
    t0 = time.perf_counter()
    server = SearchServer(files, host="127.0.0.1", port=0, engine="device", device=device)
    t_load = time.perf_counter() - t0
    server.start()
    try:
        lat = []
        with socket.create_connection(server.address, timeout=600) as sock:
            f = sock.makefile("rw", encoding="utf-8")
            for threshold, fmt in CASES:
                t0 = time.perf_counter()
                f.write(json.dumps({"queries": seqs, "threshold": threshold,
                                    "format": fmt}) + "\n")
                f.flush()
                reply = json.loads(f.readline())
                lat.append(time.perf_counter() - t0)
                check(reply.get("ok") is True, f"server error: {reply}")
                check(reply["output"] == outputs[(threshold, fmt)],
                      f"served bytes differ from kwage --device at -t {threshold} {fmt}")
        resident = server.searcher.resident_bytes
    finally:
        server.shutdown()
    del server
    print(f"phase 3 serve: {resident} B resident, load {t_load:.2f} s, "
          f"{len(CASES)} requests == phase 2 bytes, latency "
          + ", ".join(f"{x * 1e3:.1f} ms" for x in lat), flush=True)
    return outputs


# --- phase 6: the device ingest (kwage-maestro-torch --device-build) ---------------

ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_reads(rng, genome: np.ndarray, coverage: int) -> np.ndarray:
    """ASCII reads uint8 [n, READ_LEN] at ``coverage`` of a genome of 2-bit
    codes: either strand, SUB_RATE substitutions, N_RATE N calls."""
    n = genome.shape[0] * coverage // READ_LEN
    starts = rng.integers(0, genome.shape[0] - READ_LEN + 1, size=n)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    rev = rng.random(n) < 0.5
    codes[rev] = 3 - codes[rev, ::-1]
    sub = rng.random(codes.shape) < SUB_RATE
    codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) % 4
    reads = ACGT[codes]
    reads[rng.random(codes.shape) < N_RATE] = ord("N")
    return reads


def write_fastq(path: str, reads: np.ndarray) -> None:
    """Fixed-width FASTQ records: @r<9 digits>, the read, +, quality I."""
    n = reads.shape[0]
    head = np.empty((n, 11), np.uint8)
    head[:, :2] = np.frombuffer(b"@r", np.uint8)
    head[:, 2:] = (np.arange(n)[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + 48
    nl = np.full((n, 1), 10, np.uint8)
    plus = np.broadcast_to(np.frombuffer(b"\n+\n", np.uint8), (n, 3))
    qual = np.full((n, READ_LEN), ord("I"), np.uint8)
    with open(path, "wb") as f:
        f.write(np.concatenate([head, nl, reads, plus, qual, nl], axis=1).tobytes())


def exact_bloom(reads: np.ndarray) -> tuple[BloomParam, np.ndarray, np.ndarray]:
    """The exact ground truth of one accession's filter: its reads joined
    with N, every canonical k-mer counted exactly, the words seen
    MIN_COUNT times or more (returned too) hashed into an image of the
    adaptive shape."""
    joined = np.concatenate([reads, np.full((reads.shape[0], 1), ord("N"), np.uint8)], axis=1)
    uniq, counts = np.unique(canonical_kmers_native(joined.tobytes(), INGEST_K),
                             return_counts=True)
    kept = uniq[counts >= MIN_COUNT]
    param = optimal_bloom_param(INGEST_K, int(kept.size), 0.25)
    image = np.zeros(param.filter_len, bool)
    image[(murmur32_native(kept, INGEST_K, param.num_hash)
           & np.uint32(param.filter_len - 1)).reshape(-1)] = True
    return param, np.packbits(image, bitorder="little"), kept


def run_maestro_golden(work: str) -> None:
    """The golden corpus through the port's Maestro with --device-build and
    --device-transpose: the .db files must have the golden digests."""
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(GOLDEN, "digests.json")) as f:
        digests = json.load(f)
    write_inventory(os.path.join(work, "inv.bin"),
                    [FilterInfo(run_accession=str_to_accession(a)) for a in manifest["accessions"]])
    opt = MaestroOptions(
        metadata_file=os.path.join(work, "inv.bin"), scratch_bloom_dir=os.path.join(work, "bloom"),
        scratch_database_dir=os.path.join(work, "db"), status_file=os.path.join(work, "st.bin"),
        kmer_len=manifest["k"], min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"], min_log_2_filter_len=manifest["minL"],
        max_log_2_filter_len=manifest["maxL"], min_log_2_count_len=manifest["minLc"],
        max_log_2_count_len=manifest["maxLc"], num_workers=2, device_build=True,
        device_transpose=True, device_batch=16)
    m = Maestro(opt, LocalFastaResolver(GOLDEN_DATA))
    m.restore()
    m.run()
    check(all(s == STATUS_DATABASE_SUCCESS for s in m.status), f"golden run: {m.summary()}")
    for gi in range(len(manifest["db_groups"])):
        got = sha256(os.path.join(work, "db", f"sra.{gi + 1}.db"))
        check(got == digests[f"sra.{gi}.db"], f"golden .db group {gi} differs")


# The step functions --profile times: (module, names) of the port.
INGEST_STEPS = [
    (torch_maestro, ("build_db_from_bloom_files",)),
    (torch_make_bloom, ("prepare_device_batch", "dispatch_device_batch", "scatter_device_batch",
                        "complete_device_batch",
                        "build_bloom_device", "_merge_sorted_counts", "count_kmers",
                        "_pad_reads_to_batch", "count_kmers_multi_packed", "tensor_to_words_u64",
                        "bloom_set_bits", "set_filter_bits")),
]
SRIRACHA_STEPS = [
    (torch_sriracha_cli, ("load_subject_kmers", "format_results")),
    (tsr, ("build_tables",)),
]


@contextlib.contextmanager
def step_profile(device: torch.device, steps):
    """Step timers on the (module, names) functions of ``steps`` (each
    call's host-clock time, a device synchronize after it) and
    torch.profiler over the
    device's activity. The functions are restored on exit. Yields a
    dict that holds the report afterwards: {"steps": [(name, s, calls)],
    "busy_s": device busy seconds, "table": the profiler's table}."""
    totals = collections.defaultdict(lambda: [0.0, 0])
    saved = []

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                totals[name][0] += time.perf_counter() - t0
                totals[name][1] += 1
        return wrapper

    for module, names in steps:
        short = module.__name__.rsplit(".", 1)[1]
        for name in names:
            fn = getattr(module, name)
            saved.append((module, name, fn))
            setattr(module, name, timed(f"{short}.{name}", fn))
    report: dict = {}
    activities = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
                  else torch.profiler.ProfilerActivity.CPU]
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield report
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    events = prof.key_averages()
    report["steps"] = sorted(((n, t, c) for n, (t, c) in totals.items()), key=lambda x: -x[1])
    report["busy_s"] = sum(e.self_device_time_total for e in events) / 1e6
    report["table"] = events.table(sort_by="self_device_time_total", row_limit=25)


def run_ingest(work: str, device: torch.device, ingest, seed: int,
               profile: bool = False) -> dict:
    """Phase 6 through the port's kwage-maestro-torch; returns the shapes
    phase 4 times the ingest kernels at. ``profile``: break the call
    down (``step_profile``) and print the breakdown."""
    rng = np.random.default_rng(seed + 1)
    src = os.path.join(work, "src")
    os.makedirs(src)
    accs, genomes, truth, total_bp = [], {}, {}, 0
    t0 = time.perf_counter()
    for genome_bp, coverage, count in ingest:
        for _ in range(count):
            acc = f"SRR{2000000 + len(accs)}"
            accs.append(acc)
            genomes[acc] = rng.integers(0, 4, size=genome_bp, dtype=np.uint8)
            reads = make_reads(rng, genomes[acc], coverage)
            total_bp += reads.size
            write_fastq(os.path.join(src, f"{acc}.fastq"), reads)
            truth[acc] = exact_bloom(reads)
            del reads
    t_data = time.perf_counter() - t0
    write_inventory(os.path.join(work, "inv.bin"),
                    [FilterInfo(run_accession=str_to_accession(a)) for a in accs])

    with step_profile(device, INGEST_STEPS) if profile else contextlib.nullcontext() as report:
        t0 = time.perf_counter()
        rc = torch_maestro_main([
            "--meta", os.path.join(work, "inv.bin"), "--scratch", work,
            "--status", os.path.join(work, "status.bin"), "--source-dir", src,
            "-k", str(INGEST_K), "--min-kmer-count", str(MIN_COUNT), "--device-build",
            "--device-transpose", "--device-batch", "16", "--workers", "2", "--save.bloom"])
        t_dev = time.perf_counter() - t0
    check(rc == 0, f"kwage-maestro-torch exited {rc}")
    if profile:
        print(f"profile: kwage-maestro-torch {t_dev:.3f} s under the step timers and the "
              f"profiler; device busy (kernel, copy and memset self time) "
              f"{report['busy_s']:.4f} s, idle share {1 - report['busy_s'] / t_dev:.4f}")
        for name, secs, calls in report["steps"]:
            print(f"profile step {name:<40} {secs:8.3f} s  x{calls}")
        print(report["table"], flush=True)
    status, _ = read_status_file(os.path.join(work, "status.bin"), len(accs))
    check(bool((status == STATUS_DATABASE_SUCCESS).all()), f"statuses {status.tolist()}")

    # Every .bloom == the exact ground truth.
    for acc in accs:
        rec = read_bloom_file(os.path.join(work, "bloom", f"{acc}.bloom"))
        param, bits, _ = truth[acc]
        check(rec.param == param, f"{acc}: param {rec.param} != ground truth {param}")
        check(rec.bits.tobytes() == bits.tobytes(), f"{acc}: bits differ from the ground truth")
        check(rec.test_crc32(), f"{acc}: bad crc32")

    # Every .db == the host pack of the same .bloom files.
    dbs = sorted(os.path.join(work, "database", f) for f in os.listdir(os.path.join(work, "database")))
    packed = 0
    for db in dbs:
        reader = open_database(db)
        members = [accession_to_str(reader.read_filter_info(i).run_accession)
                   for i in range(reader.header.num_filter)]
        packed += len(members)
        host = os.path.join(work, "host.db")
        build_db_from_bloom_files(host, reader.header.param,
                                  [os.path.join(work, "bloom", f"{a}.bloom") for a in members])
        check(sha256(db) == sha256(host), f"{db}: differs from the host pack")
        os.remove(host)
    check(packed == len(accs), f"{packed} filters packed of {len(accs)}")

    # kwage --device over the new .db files == the host engine.
    # Genome queries whose k-mers the ground truth kept (>= 90% of them)
    # must hit their own accession at -t 0.5: a Bloom filter has no false
    # negatives.
    queries, owners = [], []
    for acc in (accs[0], accs[1], accs[-2], accs[-1]):
        g, kept = genomes[acc], truth[acc][2]
        while len([o for o in owners if o == acc]) < 2:
            start = int(rng.integers(0, g.shape[0] - 300))
            q = ACGT[g[start : start + 300]].tobytes()
            if np.isin(canonical_kmers_native(q, INGEST_K), kept).mean() >= 0.9:
                queries.append(q.decode())
                owners.append(acc)
    queries += ["".join(rng.choice(list("ACGT"), size=250)) for _ in range(2)]
    base = [a for db in dbs for a in ("-d", db)]
    for threshold in (1.0, 0.5):
        got = {}
        for name, main, extra in (("device", torch_kwage_main, ["--device"]),
                                  ("host", torch_kwage_main, [])):
            out = os.path.join(work, f"{name}.csv")
            check(main(base + ["-t", str(threshold), "--o.csv", "-o", out] + extra + queries) == 0,
                  f"{name} kwage failed")
            with open(out) as f:
                got[name] = f.read()
        check(got["device"] == got["host"], f"--device differs from the host engine at -t {threshold}")
    hits = csv_hits(got["device"])
    for qi, acc in enumerate(owners):
        check(hits[(f"command line seq {qi}", acc)] == 1, f"query {qi} misses {acc} at -t 0.5")

    truth_params = {a: t[0] for a, t in truth.items()}

    # The host native builder (counting Bloom) on the same files.
    opts = BuildOptions(kmer_len=INGEST_K, min_kmer_count=MIN_COUNT)
    threads = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda a: build_bloom_from_file(os.path.join(src, f"{a}.fastq"), opts,
                                                      FilterInfo()), accs))
    t_host = time.perf_counter() - t0

    golden = os.path.join(work, "golden")
    os.makedirs(golden)
    run_maestro_golden(golden)

    del truth
    small = [truth_params[a] for a in accs[: ingest[0][2]]]
    print(f"phase 6 ingest: {len(accs)} accessions, {total_bp / 1e6:.1f} Mbp of {READ_LEN} bp "
          f"reads (data + ground truth {t_data:.1f} s); kwage-maestro-torch --device-build "
          f"--device-transpose {t_dev:.2f} s ({total_bp / 1e6 / t_dev:.2f} Mbp/s); "
          f"{len(accs)} .bloom == exact ground truth (L "
          f"{sorted({p.log_2_filter_len for p in truth_params.values()})}); "
          f"{len(dbs)} .db == host pack; --device search == host engine at -t 1.0 and 0.5; "
          f"golden digests reproduced; host native builder, {threads} threads, "
          f"{t_host:.2f} s ({total_bp / 1e6 / t_host:.2f} Mbp/s)", flush=True)
    genome_bp, coverage, count = ingest[0]
    rows = count * (genome_bp * coverage // READ_LEN)
    return {"rows": max(64, 1 << int(np.ceil(np.log2(rows)))),
            "blen": max(128, -(-READ_LEN // 128) * 128), "num_acc": count,
            "log2_len": small[0].log_2_filter_len, "num_hash": small[0].num_hash}


# --- phase 7: entry() -----------------------------------------------------------------

def run_entry(device: torch.device) -> None:
    """The port's entry() forward on the card against the same forward
    on CPU copies (every wrapper's plain version)."""
    fn, args = entry(device)
    query = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, 256)].copy()
    query[100] = ord("N")
    cases = [args, (args[0], torch.from_numpy(query).to(device))]
    sums = []
    for case in cases:
        got = fn(*case)
        want = fn(*(a.cpu() for a in case))
        check(torch.equal(got.cpu(), want), "entry() forward differs from its plain path")
        sums.append(int(want.sum()))
    check(sums[1] > 0, "the ACGT query hit nothing")
    print(f"phase 7 entry: forward on the card == plain path; hit-count sums {sums}", flush=True)


# --- phase 8: kwage-sriracha-torch --device -----------------------------------------

def mutate(rng, codes: np.ndarray) -> np.ndarray:
    """Codes with SUB_RATE substitutions per base, on a random strand."""
    codes = codes.copy()
    sub = rng.random(codes.shape) < SUB_RATE
    codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) % 4
    return 3 - codes[::-1] if rng.random() < 0.5 else codes


def make_sriracha_data(work: str, rng, n_reads: int) -> tuple[str, str, int]:
    """Query FASTA of SR_SUBJECTS genomes and one FASTQ: 20% of the reads
    drawn from the first subjects with SUB_RATE substitutions (about 74%
    of them exact), 75% random background, 5% low-complexity (poly-A,
    dinucleotide repeats), N-bearing or shorter than k; then SR_LONG reads
    of SR_LONG_BP, half from the last SR_LONG_ONLY subjects (which no short
    read comes from), half random, in random places. Returns (queries,
    reads, bases)."""
    genomes = rng.integers(0, 4, size=(SR_SUBJECTS, SR_SUBJECT_BP), dtype=np.uint8)
    queries = os.path.join(work, "queries.fasta")
    with open(queries, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(b">query %d\n" % i + ACGT[g].tobytes() + b"\n")
    kind = rng.choice(4, size=n_reads, p=[0.20, 0.75, 0.03, 0.02])
    reads = ACGT[rng.integers(0, 4, size=(n_reads, READ_LEN), dtype=np.uint8)]
    src = np.nonzero(kind == 0)[0]
    owner = rng.integers(0, SR_SUBJECTS - SR_LONG_ONLY, size=src.size)
    start = rng.integers(0, SR_SUBJECT_BP - READ_LEN + 1, size=src.size)
    codes = genomes[owner[:, None], start[:, None] + np.arange(READ_LEN)]
    rev = rng.random(src.size) < 0.5
    codes[rev] = 3 - codes[rev, ::-1]
    sub = rng.random(codes.shape) < SUB_RATE
    codes[sub] = (codes[sub] + rng.integers(1, 4, size=int(sub.sum()), dtype=np.uint8)) % 4
    reads[src] = ACGT[codes]
    low = np.nonzero(kind == 2)[0]
    reads[low[0::2]] = ord("A")
    reads[low[1::2]] = np.resize(np.frombuffer(b"CA", np.uint8), READ_LEN)
    nbear = np.nonzero(kind == 3)[0]
    reads[nbear[:, None], rng.integers(0, READ_LEN, size=(nbear.size, 3))] = ord("N")
    short = set(nbear[0::2].tolist())           # half of them: 5-20 bp
    short_len = dict(zip(sorted(short), rng.integers(5, 21, size=len(short)).tolist()))
    longs = {}
    for j, pos in enumerate(rng.choice(n_reads, size=SR_LONG, replace=False).tolist()):
        if j % 2 == 0:
            g = genomes[SR_SUBJECTS - SR_LONG_ONLY + (j // 2) % SR_LONG_ONLY]
            a = int(rng.integers(0, SR_SUBJECT_BP - SR_LONG_BP + 1))
            longs[pos] = ACGT[mutate(rng, g[a : a + SR_LONG_BP])].tobytes()
        else:
            longs[pos] = ACGT[rng.integers(0, 4, size=SR_LONG_BP)].tobytes()
    path = os.path.join(work, f"SRR9{n_reads:06d}.fastq")
    total = 0
    with open(path, "wb") as f:
        buf = []
        for i in range(n_reads):
            seq = longs.get(i)
            if seq is None:
                seq = reads[i, : short_len.get(i, READ_LEN)].tobytes()
            total += len(seq)
            buf.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
            if len(buf) == 65536:
                f.write(b"".join(buf))
                buf = []
        f.write(b"".join(buf))
    return queries, path, total


def timed_reads(reads, prof: dict):
    """The read iterator, with the time spent in it (FASTQ parsing) added
    to ``prof["read_s"]``."""
    prof.setdefault("read_s", 0.0)
    it = iter(reads)
    while True:
        t0 = time.perf_counter()
        try:
            read = next(it)
        except StopIteration:
            return
        finally:
            prof["read_s"] += time.perf_counter() - t0
        yield read


@contextlib.contextmanager
def sriracha_profile(time_reads: bool = False):
    """The profile dict of the port's search_reads_device under the CLI:
    the device branch of search_accession (which looks the function up in
    the device module at each call) gets ``profile=`` (restored on exit); ``time_reads`` also times its read iterator (``read_s``)."""
    prof: dict = {}
    saved = tsr.search_reads_device

    @functools.wraps(saved)
    def with_profile(reads, *args, **kwargs):
        if time_reads:
            reads = timed_reads(reads, prof)
        return saved(reads, *args, profile=prof, **kwargs)

    tsr.search_reads_device = with_profile
    try:
        yield prof
    finally:
        tsr.search_reads_device = saved


def run_sriracha(work: str, device: torch.device, seed: int, runs=SR_RUNS,
                 profile: bool = False) -> None:
    """Phase 8 through the port's kwage-sriracha-torch --device, each run
    against the host engine's bytes; on a card, each run must launch its
    route's kernel and not the other's. ``profile``: also time the read
    iterator and the SRIRACHA_STEPS functions, trace the device
    (``step_profile``) and print the breakdown."""
    data = {}
    for tag, k, t, n_reads in runs:
        if n_reads not in data:  # a run cut to fewer reads gets data of its own
            t0 = time.perf_counter()
            data[n_reads] = make_sriracha_data(work, np.random.default_rng(seed + 4), n_reads)
            print(f"phase 8 data: {SR_SUBJECTS} queries x {SR_SUBJECT_BP} bp, {n_reads} reads "
                  f"+ {SR_LONG} of {SR_LONG_BP} bp, {data[n_reads][2] / 1e6:.1f} Mbp "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        queries, path, bp = data[n_reads]
        args = ["-k", str(k), "-t", str(t), "-i", queries, path]
        before = kernels.launch_counts()
        steps = (step_profile(device, SRIRACHA_STEPS) if profile
                 else contextlib.nullcontext())
        with steps as report, sriracha_profile(profile) as prof:
            t0 = time.perf_counter()
            rc = torch_sriracha_main(args + ["--device", "-o", os.path.join(work, "dev.tsv")])
            t_dev = time.perf_counter() - t0
        check(rc == 0, f"kwage-sriracha-torch exited {rc}")
        if profile:
            print(f"profile: run {tag} kwage-sriracha-torch --device {t_dev:.3f} s under the "
                  f"step timers and the profiler; device busy {report['busy_s']:.4f} s, idle "
                  f"share {1 - report['busy_s'] / t_dev:.4f}")
            for name, secs, calls in report["steps"]:
                print(f"profile step {name:<40} {secs:8.3f} s  x{calls}")
            print(report["table"], flush=True)
        after = kernels.launch_counts()
        t0 = time.perf_counter()
        rc = torch_sriracha_main(args + ["-o", os.path.join(work, "host.tsv")])
        t_host = time.perf_counter() - t0
        check(rc == 0, f"host sriracha exited {rc}")
        with open(os.path.join(work, "dev.tsv"), "rb") as f:
            dev = f.read()
        with open(os.path.join(work, "host.tsv"), "rb") as f:
            host = f.read()
        check(dev == host, f"run {tag} (k={k}): --device TSV differs from the host engine's")
        route = "sriracha_counts_lut" if k <= 13 else "sriracha_counts_hash"
        other = "sriracha_counts_hash" if k <= 13 else "sriracha_counts_lut"
        check(device.type != "cuda" or (after[route] > before[route]
                                        and after[other] == before[other]),
              f"run {tag} (k={k}) did not take the {route} route: {before} -> {after}")
        rows = [line.split(b"\t") for line in dev.splitlines() if b"\t" in line]
        per_query = collections.Counter(r[4] for r in rows)
        perfect = sum(1 for r in rows if r[2] == b"1")
        check(len(per_query) >= SR_SUBJECTS - SR_LONG_ONLY and perfect > 0,
              f"run {tag}: {len(rows)} rows, {perfect} perfect")
        check(max(per_query.values()) == 100, f"run {tag}: no query reached the 100-match cap")
        for q in range(SR_SUBJECTS - SR_LONG_ONLY, SR_SUBJECTS):
            # Short N-bearing reads with a few valid windows may score 1 too.
            hits = [r for r in rows if r[4] == b"query %d" % q and len(r[3]) == SR_LONG_BP]
            check(len(hits) == SR_LONG // 2 // SR_LONG_ONLY,
                  f"run {tag}: query {q} lists {len(hits)} 20 kbp reads, not its own")
        shown = {k2: round(v, 3) for k2, v in prof.items() if k2.endswith("_s")}
        print(f"phase 8 sriracha run {tag}: k={k} -t {t}, {n_reads} reads + {SR_LONG} long, "
              f"{bp / 1e6:.1f} Mbp; --device {t_dev:.2f} s ({bp / 1e6 / t_dev:.2f} Mbp/s, "
              f"{after[route] - before[route]} {route} launches, profile {shown}, "
              f"{prof.get('spans')} spans); host engine {t_host:.2f} s "
              f"({bp / 1e6 / t_host:.2f} Mbp/s); TSV == host bytes, {len(rows)} rows, "
              f"{perfect} with score 1", flush=True)


# --- phase 4: kernels against their plain versions ------------------------------

def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its integer operations over the int32 rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(nbytes), "operations": int(nops)}


def murmur_ops(k: int, nh: int) -> int:
    """Integer operations of murmur3-32 over one k-mer's decoded bases for
    nh seeds: 6 a base to decode it into its message byte, 3 a message
    block to mix it, then 3 a block and 12 for the finish and mask a seed."""
    blocks = -(-k // 4)
    return 6 * k + 3 * blocks + nh * (3 * blocks + 12)


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype, f"{a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def random_words(shape, gen, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=device).random_(
        -2**31, 2**31, generator=gen)


def search_inputs(R, W, nq, nk, n_valid, gen, device):
    db = random_words((R, W), gen, device)
    idx = torch.randint(0, R, (nq, nk, NUM_HASH), dtype=torch.int32, device=device,
                        generator=gen)
    idx[0, 0, 0] = R - 1  # the last row: the largest offset
    valid = torch.zeros((nq, nk), dtype=torch.bool, device=device)
    for q, n in enumerate(n_valid):
        valid[q, :n] = True
    return db, idx, valid


def phase_kernels(device: torch.device, seed: int, ingest: dict) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    stream = lambda: torch.cuda.current_stream(device).cuda_stream  # noqa: E731
    results, lines = {}, []

    # Transpose: one pack chunk, 2048 filters x 2^21 bits.
    x = random_words((NUM_FILTER, (1 << 21) // 32), gen, device)
    got, want = tt.packed_bit_transpose(x), tt.packed_bit_transpose_ref(x)
    err = max_abs_err(got, want)
    check(err == 0, f"bit_transpose differs from its plain version (max err {err})")
    F, W = x.shape
    ms = cuda_ms(lambda: kernels.launch("bit_transpose", x.data_ptr(), got.data_ptr(),
                                        F, W, stream()), 20)
    plain = cuda_ms(lambda: tt.packed_bit_transpose_ref(x), 2)
    # Bytes: the matrix in, its transpose out. Operations: a 32 x 32 bit
    # transpose by masked swaps is 5 stages of 6 operations a word.
    results["bit_transpose"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                "shape": f"[{F}, {W}] uint32",
                                **bound(2 * nbytes_of(x), 30 * x.numel())}
    lines.append(f"bit_transpose [{F}, {W}] kernel {ms:.4f} ms "
                 f"({2 * x.numel() * 4 / ms / 1e6:.1f} GB/s) plain {plain:.3f} ms")
    del x, got, want

    # Search at the bench's fused shape, then at R*W = 2^32 words (int64 offsets).
    shapes = [("main", 1 << LOG2_FILTER_LEN, 512, [1, 3, 1024, 1000, 777, 512, 129, 0]),
              ("R=2^26", 1 << 26, 64, [1, 2, 256, 200])]
    for tag, R, W, n_valid in shapes:
        nk = max(n_valid)
        db, idx, valid = search_inputs(R, W, len(n_valid), nk, n_valid, gen, device)
        for name, fn, ref in (("search_complete", ts.search_complete, ts.complete_ref),
                              ("search_counts", ts.search_counts, ts.counts_ref)):
            got, want = fn(db, idx, valid), ref(db, idx, valid)
            err = max_abs_err(got, want)
            check(err == 0, f"{name} differs from its plain version at {tag} (max err {err})")
            args = (db.data_ptr(), idx.data_ptr(), valid.data_ptr(), got.data_ptr(),
                    len(n_valid), nk, NUM_HASH, W)
            ms = cuda_ms(lambda: kernels.launch(name, *args, stream()), 20)
            plain = cuda_ms(lambda: ref(db, idx, valid), 5)
            gathered = sum(n_valid) * NUM_HASH * W * 4
            lines.append(f"{name} {tag} R={R} W={W} nq={len(n_valid)} nk={nk}: kernel "
                         f"{ms:.4f} ms ({gathered / ms / 1e6:.1f} GB/s gathered) "
                         f"plain {plain:.3f} ms")
            prev = results.get(name)
            if prev is None:
                # Bytes: the rows this run's valid k-mers gather (each once),
                # the indices, the flags and the output. Operations: one AND
                # a gathered word, and for the counts about 5 more a k-mer
                # and word to add it into carry-save planes.
                per_word = NUM_HASH + (5 if name == "search_counts" else 0)
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                 "shape": f"R={R} W={W} nq={len(n_valid)} nk={nk} nh={NUM_HASH}, "
                                          f"{sum(n_valid)} valid k-mers",
                                 **bound(gathered + nbytes_of(idx, valid, got),
                                         sum(n_valid) * W * per_word)}
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"], err)
        del db, idx, valid
        torch.cuda.empty_cache()

    def record(name, tag, err, ms, plain, note="", nbytes=0, nops=0):
        """One comparison; ``ms`` None: checked, not timed. A kernel's first
        timed comparison (the main path's shape) gives its line of the
        result, with the bound of ``nbytes`` and ``nops``."""
        check(err == 0, f"{name} differs from its plain version at {tag} (max err {err})")
        lines.append(f"{name} {tag}: == plain{note}" if ms is None else
                     f"{name} {tag}: kernel {ms:.4f} ms{note} plain {plain:.3f} ms")
        if name in results:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        else:
            check(ms is not None and nbytes > 0, f"{name}: first comparison not timed")
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "shape": tag,
                             **bound(nbytes, nops)}

    # canonical_kmers: the fused batch's packed block, rows x blen bases.
    R, blen, k = ingest["rows"], ingest["blen"], INGEST_K
    packed = random_words((R, blen // 16), gen, device)
    vw = random_words((R, blen // 32), gen, device)
    for _ in range(5):  # ~1/64 of the bases invalid
        vw |= random_words((R, blen // 32), gen, device)
    words, valid = tk.canonical_kmers_packed(packed, vw, k, blen)
    ref_words, ref_valid = tk.canonical_kmers_packed_ref(packed, vw, k, blen)
    err = max(max_abs_err(valid, ref_valid), int((words != ref_words).sum()))
    del ref_words, ref_valid
    ms = cuda_ms(lambda: kernels.launch(
        "canonical_kmers", packed.data_ptr(), vw.data_ptr(), words.data_ptr(), valid.data_ptr(),
        R, blen // 16, blen // 32, blen, k, stream()), 10)
    plain = cuda_ms(lambda: tk.canonical_kmers_packed_ref(packed, vw, k, blen), 2)
    # Bytes: the packed reads in, 9 bytes a window out. Operations: about
    # 25 a window (two funnel shifts, masks, the bit reversal, the compare).
    record("canonical_kmers", f"[{R}, {blen}] k={k}", err, ms, plain,
           f" ({words.numel() / ms / 1e6:.1f} G windows/s)",
           nbytes_of(packed, vw, words, valid), 25 * words.numel())
    del packed, vw, words, valid
    torch.cuda.empty_cache()

    # select_runs and bloom_set_bits over the fused batch's window count:
    # sorted (acc, word) pairs from a pool (runs of ~8), invalid tail.
    n, num_acc = R * (blen - k + 1), ingest["num_acc"]
    pool = torch.randint(0, 1 << 62, (n // 8,), device=device, generator=gen)
    pick = torch.randint(0, n // 8, (n,), device=device, generator=gen)
    acc = (pick % (num_acc + 6)).clamp_(max=num_acc)  # ~30% invalid
    acc_s, words_s = tcount.sort_windows(acc, pool[pick])
    del pool, pick, acc
    sel, nv = tcount.select_runs(acc_s, words_s, num_acc, MIN_COUNT)
    ref_sel, ref_nv = tcount.select_runs_ref(acc_s, words_s, num_acc, MIN_COUNT)
    err = max(max_abs_err(sel, ref_sel), max_abs_err(nv, ref_nv))
    check(int(nv.sum()) > 0, "select_runs selected nothing")
    del ref_sel, ref_nv
    out_nv = torch.zeros_like(nv)
    ms = cuda_ms(lambda: kernels.launch(
        "select_runs", acc_s.data_ptr(), words_s.data_ptr(), sel.data_ptr(), out_nv.data_ptr(),
        n, num_acc, MIN_COUNT, stream()), 10)
    plain = cuda_ms(lambda: tcount.select_runs_ref(acc_s, words_s, num_acc, MIN_COUNT), 2)
    # Bytes: the sorted pairs in, the flags and counts out. Operations:
    # about 10 a position (two compares with the neighbours, the run length).
    record("select_runs", f"n={n} num_acc={num_acc} min_count={MIN_COUNT}", err, ms, plain,
           f" ({n / ms / 1e6:.1f} G positions/s)",
           nbytes_of(acc_s, words_s, sel, nv), 10 * n)

    L, nh = ingest["log2_len"], ingest["num_hash"]
    slot = torch.tensor(list(range(num_acc)) + [-1], dtype=torch.int32, device=device)
    got = tcount.bloom_set_bits(acc_s, words_s, sel, slot, k, nh, L)
    want = tcount.bloom_set_bits_ref(acc_s, words_s, sel, slot, k, nh, L)
    err = max_abs_err(got, want)
    ms = cuda_ms(lambda: kernels.launch(
        "bloom_set_bits", acc_s.data_ptr(), words_s.data_ptr(), sel.data_ptr(), slot.data_ptr(),
        got.data_ptr(), n, num_acc, k, nh, L, got.shape[1], stream()), 10)
    plain = cuda_ms(lambda: tcount.bloom_set_bits_ref(acc_s, words_s, sel, slot, k, nh, L), 2)
    n_sel = int(nv.sum())
    # Bytes: the flag of every position, the (accession, word) pair of the
    # selected ones alone (the rest are never read), the filter images out
    # once. Operations: murmur for the selected words, 3 a position to skip
    # the rest.
    pair_bytes = acc_s.element_size() + words_s.element_size()
    record("bloom_set_bits", f"n={n} selected={n_sel} num_acc={num_acc} L={L} nh={nh}",
           err, ms, plain, f" ({n_sel * nh / ms / 1e6:.1f} G bits/s)",
           nbytes_of(sel, slot, got) + n_sel * pair_bytes,
           n_sel * murmur_ops(k, nh) + 3 * n)
    del acc_s, words_s, sel, nv, got, want
    torch.cuda.empty_cache()

    # bloom_set_bits at num_acc * 2^L = 2^32 bits: bit offsets past 2^31.
    n, num_acc, L = 1 << 20, 4, 30
    acc = torch.randint(0, num_acc + 1, (n,), device=device, generator=gen)
    words = torch.randint(0, 1 << 62, (n,), device=device, generator=gen)
    sel = torch.rand((n,), device=device, generator=gen) < 0.5
    slot = torch.tensor([0, 1, 2, 3, -1], dtype=torch.int32, device=device)
    got = tcount.bloom_set_bits(acc, words, sel, slot, k, 3, L)
    want = tcount.bloom_set_bits_ref(acc, words, sel, slot, k, 3, L)
    check(bool(got[3].any()), "no bit landed in the last filter")
    record("bloom_set_bits", f"num_acc={num_acc} L={L} (2^32 bits)", max_abs_err(got, want),
           cuda_ms(lambda: kernels.launch(
               "bloom_set_bits", acc.data_ptr(), words.data_ptr(), sel.data_ptr(),
               slot.data_ptr(), got.data_ptr(), n, num_acc, k, 3, L, got.shape[1], stream()), 10),
           cuda_ms(lambda: tcount.bloom_set_bits_ref(acc, words, sel, slot, k, 3, L), 2))
    del acc, words, sel, got, want
    torch.cuda.empty_cache()

    # murmur32 as slice_indices at the ingest's distinct-word count, then
    # at the entry() forward's shape.
    for tag, n, nh, L in (("ingest", 1 << 23, ingest["num_hash"], ingest["log2_len"]),
                          ("entry", 226, 5, 14)):
        words = torch.randint(0, 1 << 62, (n,), device=device, generator=gen)
        got = th.slice_indices(words, k, nh, L)
        err = max_abs_err(got, th.murmur32_ref(words, k, nh) & ((1 << L) - 1))
        ms = cuda_ms(lambda: kernels.launch("murmur32", words.data_ptr(), got.data_ptr(), n, k,
                                            nh, (1 << L) - 1, stream()), 20)
        plain = cuda_ms(lambda: th.murmur32_ref(words, k, nh) & ((1 << L) - 1), 3)
        record("murmur32", f"{tag} n={n} nh={nh} L={L}", err, ms, plain,
               f" ({n * nh / ms / 1e6:.1f} G hashes/s)",
               nbytes_of(words, got), n * murmur_ops(k, nh))
    del words, got
    small_block_checks(device, seed, results, lines)
    sriracha_kernel_checks(device, seed, record, lines)
    print("phase 4 kernels == plain versions, bit for bit: " + "; ".join(lines), flush=True)
    return results


def small_block_checks(device: torch.device, seed: int, results: dict, lines: list) -> None:
    """The ingest kernels at every k branch on a small block of reads
    holding every byte value: k = 15 and 16 (a word of 30 and 32 bits),
    31, and 32 (all 64 bits, the sign bit set; murmur with no tail block).
    canonical_kmers through both entries (packed and ASCII, which must
    also agree with each other), murmur32 and slice_indices, select_runs
    and bloom_set_bits, each against its plain version. Then the ASCII
    entry timed at entry()'s shape."""
    rng = np.random.default_rng(seed + 2)
    b = ACGT[rng.integers(0, 4, size=(64, READ_LEN))]
    b[rng.random(b.shape) < 0.01] = ord("N")
    b[1:3, :128] = np.arange(256, dtype=np.uint8).reshape(2, 128)
    b[3] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=READ_LEN)]
    ascii = torch.from_numpy(b).to(device)
    packed, vw = tk.pack_to_device(b, device)
    acc_rows = torch.arange(64, device=device) % 5  # accession 4: dropped windows
    slot = torch.tensor([0, -1, 2, 3, -1], dtype=torch.int32, device=device)
    errs = collections.defaultdict(int)

    def diff(a, b):
        check(a.shape == b.shape and a.dtype == b.dtype, f"{a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        return int((a != b).sum())

    for k in (15, 16, 31, 32):
        words, valid = tk.canonical_kmers_packed(packed, vw, k, READ_LEN)
        ref = tk.canonical_kmers_packed_ref(packed, vw, k, READ_LEN)
        a_words, a_valid = tk.canonical_kmers(ascii, k)
        a_ref = tk.canonical_kmers_ascii_ref(ascii, k)
        errs["canonical_kmers"] += (diff(words, ref[0]) + diff(valid, ref[1])
                                    + diff(a_words, a_ref[0]) + diff(a_valid, a_ref[1])
                                    + diff(a_words, words) + diff(a_valid, valid))
        check(bool(valid.any()) and not bool(valid.all()), f"k={k}: valid windows all or none")
        if k == 32:
            check(bool((words < 0).any()), "k=32: no word with its top bit set")
        flat = words.reshape(-1)
        errs["murmur32"] += (diff(th.murmur32(flat, k, 5), th.murmur32_ref(flat, k, 5))
                             + diff(th.slice_indices(flat, k, 5, 22),
                                    th.murmur32_ref(flat, k, 5) & ((1 << 22) - 1)))
        acc = torch.where(valid, acc_rows[:, None], 4).reshape(-1)
        acc_s, words_s = tcount.sort_windows(acc, flat)
        sel, nv = tcount.select_runs(acc_s, words_s, 4, 1)
        ref_sel, ref_nv = tcount.select_runs_ref(acc_s, words_s, 4, 1)
        errs["select_runs"] += diff(sel, ref_sel) + diff(nv, ref_nv)
        for L in (5, 12):
            errs["bloom_set_bits"] += diff(
                tcount.bloom_set_bits(acc_s, words_s, sel, slot, k, 3, L),
                tcount.bloom_set_bits_ref(acc_s, words_s, sel, slot, k, 3, L))
    # The window code's edges: lengths that end inside a packed word or just
    # past a 256-window chunk, an N at the first, last, 16th and 32nd base, a
    # lower-case row, a row of every byte value, at k = 1 and around the
    # 32- and 64-bit word boundaries.
    for length in (17, 33, 255, 257, 289, 1000):
        e = ACGT[rng.integers(0, 4, size=(7, length))]
        e[0, 0] = e[1, -1] = e[2, 15] = e[3, min(31, length - 1)] = ord("N")
        e[4] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=length)]
        e[5, : min(256, length)] = np.arange(256, dtype=np.uint8)[: min(256, length)]
        e_ascii = torch.from_numpy(e).to(device)
        e_packed, e_vw = tk.pack_to_device(e, device)
        for k in (1, 15, 16, 17, 31, 32):
            if k > length:
                continue
            words, valid = tk.canonical_kmers_packed(e_packed, e_vw, k, length)
            ref = tk.canonical_kmers_packed_ref(e_packed, e_vw, k, length)
            a_words, a_valid = tk.canonical_kmers(e_ascii, k)
            a_ref = tk.canonical_kmers_ascii_ref(e_ascii, k)
            errs["canonical_kmers"] += (diff(words, ref[0]) + diff(valid, ref[1])
                                        + diff(a_words, a_ref[0]) + diff(a_valid, a_ref[1])
                                        + diff(a_words, words) + diff(a_valid, valid))
            check(not bool(valid[0, 0]) and not bool(valid[1, -1]) and bool(valid[4].all()),
                  f"k={k} length={length}: validity at the first or last base")
    lines.append("canonical_kmers (packed and ASCII) at k=1, 15, 16, 17, 31, 32 on lengths "
                 "17, 33, 255, 257, 289, 1000 with N at the first, last, 16th, 32nd base == plain")
    for name, err in errs.items():
        check(err == 0, f"{name} differs from its plain version on the small block ({err})")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    lines.append("canonical_kmers (packed and ASCII), murmur32, slice_indices, select_runs, "
                 f"bloom_set_bits at k=15, 16, 31, 32 on [64, {READ_LEN}] == plain")

    query = torch.from_numpy(ACGT[rng.integers(0, 4, size=(1, 256))]).to(device)
    words, valid = tk.canonical_kmers(query, INGEST_K)
    ms = cuda_ms(lambda: kernels.launch(
        "canonical_kmers_ascii", query.data_ptr(), words.data_ptr(), valid.data_ptr(), 1,
        query.shape[1], query.shape[1], INGEST_K,
        torch.cuda.current_stream(device).cuda_stream), 20)
    plain = cuda_ms(lambda: tk.canonical_kmers_ascii_ref(query, INGEST_K), 3)
    lines.append(f"canonical_kmers ASCII entry [1, {query.shape[1]}] k={INGEST_K}: kernel "
                 f"{ms:.4f} ms plain {plain:.3f} ms")


def sriracha_batch(rng, genomes: np.ndarray, B: int, L: int, read_len: int):
    """ASCII reads uint8 [B, L] of ``read_len`` bases (zero padding after),
    a fifth drawn from ``genomes`` with substitutions, some with N; the
    lengths int32 [B], the last rows 0 (batch padding)."""
    b = np.zeros((B, L), np.uint8)
    b[:, :read_len] = ACGT[rng.integers(0, 4, size=(B, read_len))]
    for r in range(0, B, 5):
        g = genomes[int(rng.integers(0, genomes.shape[0]))]
        a = int(rng.integers(0, g.shape[0] - read_len + 1))
        b[r, :read_len] = ACGT[mutate(rng, g[a : a + read_len])]
    b[rng.random((B, L)) < 0.001] = ord("N")
    b[:, read_len:] = 0
    lengths = np.full(B, read_len, np.int32)
    lengths[-3:] = 0
    b[-3:] = 0
    return b, lengths


def subject_sets(genomes: np.ndarray, k: int) -> list[tuple[str, np.ndarray]]:
    """load_subject_kmers' output for the genomes: sorted unique canonical
    words."""
    return [(f"query {i}", np.unique(canonical_kmers_native(ACGT[g].tobytes(), k)))
            for i, g in enumerate(genomes)]


def sriracha_kernel_checks(device: torch.device, seed: int, record, lines: list) -> None:
    """sriracha_counts (both probes), subject_table and canonical_kmers'
    ASCII entry (at phase 8's batch shapes, timed) against their plain
    versions, bit for bit: at phase 8's batch shape (512 x 256, 150 bp
    reads, 40 subjects of 30 kbp) at k = 21 and 11, timed; on a small block
    holding every byte value at k = 3, 13, 14, 16, 31, 32; on batches of
    the path's long-read shape (4 x 2^15 and 512 x 2^15: reads of 2^15
    bases and 20 kbp, the rest empty; the tiled sort), timed; on batches
    that mix rows of 0, 1, 2^14 - 1, 2^14, 2^14 + 1 and more valid words
    (2^15 and 2^16 buckets). Then both probes timed at 8 k, 64 k, 256 k and
    1 M k-mers per group at k = 11."""
    rng = np.random.default_rng(seed + 5)
    stream = torch.cuda.current_stream(device).cuda_stream
    genomes = rng.integers(0, 4, size=(SR_SUBJECTS, SR_SUBJECT_BP), dtype=np.uint8)
    b, lengths = sriracha_batch(rng, genomes, 512, 256, READ_LEN)
    reads, lens = torch.from_numpy(b).to(device), torch.from_numpy(lengths).to(device)

    def counts(tag, words, valid, lens, tables, timed):
        """One comparison of sriracha_counts with its plain version."""
        got = tsr.sriracha_counts(words, valid, lens, tables)
        want = tsr.sriracha_counts_ref(words, valid, lens, tables)
        err = max_abs_err(got, want)
        ms = plain = None
        nbytes = nops = 0
        if timed:
            scratch = tsr.counts_scratch(*words.shape, device)
            launch = tsr.counts_launch(words, valid, lens, tables, got, scratch)
            ms = cuda_ms(lambda: kernels.launch(*launch), 20)
            plain = cuda_ms(lambda: tsr.sriracha_counts_ref(words, valid, lens, tables), 3)
            # Bytes: the word and flag of every window that fits its read
            # (the rest are never read), the lengths in, the counts out, and
            # one table entry (LUT: 4 bytes; hash: a 96-byte bucket row) a
            # distinct word and group. Operations: a merge sort's n log2 n
            # compare-exchanges of 3 operations, 3 a word to dedup and probe.
            nk = want[:, tables.ns].double().cpu()
            distinct = int(want[:, tables.ns + 1].sum())
            groups = -(-tables.ns // 32)
            fit = int((lens.long() - tables.k + 1).clamp(0, words.shape[1]).sum())
            nbytes = (fit * (words.element_size() + valid.element_size())
                      + nbytes_of(lens, got)
                      + distinct * groups * (4 if tables.route == "lut" else 96))
            nops = int((3 * nk * torch.log2(nk.clamp(min=2)).ceil() + 3 * nk).sum())
        hits = int(want[:, : tables.ns].sum())
        check(hits > 0, f"sriracha_counts {tag}: no subject hit")
        n_long = int((want[:, tables.ns] > tsr.MAX_SHARED_WORDS).sum())
        record(f"sriracha_counts_{tables.route}", tag, err, ms, plain,
               f" ({hits} hits, {n_long} rows above a tile)", nbytes, nops)

    def kmers(tag, ascii_reads, k):
        """canonical_kmers' ASCII entry on a batch of the path against its
        plain version, timed; returns the kernel's (words, valid)."""
        words, valid = tk.canonical_kmers(ascii_reads, k)
        ref_words, ref_valid = tk.canonical_kmers_ascii_ref(ascii_reads, k)
        err = max(max_abs_err(valid, ref_valid), int((words != ref_words).sum()))
        check(bool(valid.any()) and not bool(valid.all()), f"{tag}: valid windows all or none")
        del ref_words, ref_valid
        B, L = ascii_reads.shape
        ms = cuda_ms(lambda: kernels.launch(
            "canonical_kmers_ascii", ascii_reads.data_ptr(), words.data_ptr(),
            valid.data_ptr(), B, L, L, k, stream), 20)
        plain = cuda_ms(lambda: tk.canonical_kmers_ascii_ref(ascii_reads, k), 2)
        record("canonical_kmers", f"ASCII {tag} k={k}", err, ms, plain)
        return words, valid

    for k in (21, 11):
        subj = subject_sets(genomes, k)
        words, valid = kmers("[512, 256]", reads, k)
        if k <= 14:
            sm = tsr.subjects_matrix(subj, device)
            table = tsr.subject_table(sm, k)
            size = 1 << (2 * k)
            err = max_abs_err(table, tsr.subject_table_ref(sm, k))
            ms = cuda_ms(lambda: kernels.launch("subject_table", sm.data_ptr(), table.data_ptr(),
                                                sm.shape[0], sm.shape[1], size, stream), 20)
            plain = cuda_ms(lambda: tsr.subject_table_ref(sm, k), 3)
            # Bytes: the subjects' words in, the tables out once.
            # Operations: 3 a word (range check, address, bit).
            record("subject_table", f"{sm.shape[0]} x {sm.shape[1]} words k={k}", err, ms, plain,
                   "", nbytes_of(sm, table), 3 * sm.numel())
            counts(f"[512, 256] k={k}", words, valid, lens, tsr.LutTables(table, k, len(subj)),
                   True)
            del sm, table
        counts(f"[512, 256] k={k}", words, valid, lens, tsr.build_hash_tables(subj, k, device),
               True)
    torch.cuda.empty_cache()

    # Every byte value, every k branch: 3 (a 64-entry table), 13, 14 (the
    # largest LUT, 1 GiB a group), 16, 31 and 32 (the sign bit).
    b2, lengths2 = sriracha_batch(rng, genomes, 64, 256, READ_LEN)
    b2[1:3, :128] = np.arange(256, dtype=np.uint8).reshape(2, 128)
    b2[3, :READ_LEN] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=READ_LEN)]
    small, small_lens = torch.from_numpy(b2).to(device), torch.from_numpy(lengths2).to(device)
    for k in (3, 13, 14, 16, 31, 32):
        subj = subject_sets(genomes, k)
        words, valid = tk.canonical_kmers(small, k)
        routes = [tsr.build_hash_tables(subj, k, device)]
        if k <= 14:
            sm = tsr.subjects_matrix(subj, device)
            err = max_abs_err(tsr.subject_table(sm, k), tsr.subject_table_ref(sm, k))
            record("subject_table", f"small k={k}", err, None, None)
            routes.append(tsr.build_lut_tables(subj, k, device))
        for tables in routes:
            counts(f"small [64, 256] k={k}", words, valid, small_lens, tables, False)
        del routes
        torch.cuda.empty_cache()

    # Reads of 2^15 bases and of 20 kbp in the 32768 bucket: in a batch of 4
    # rows as the path now pads it, and of 512 rows as it did; the long rows
    # sort in tiles across blocks.
    for B in (4, 512):
        b3 = np.zeros((B, 1 << 15), np.uint8)
        lengths3 = np.zeros(B, np.int32)
        lengths3[:3] = [1 << 15, SR_LONG_BP, SR_LONG_BP]
        for r in range(3):
            b3[r, : lengths3[r]] = ACGT[np.resize(mutate(rng, genomes[r]), lengths3[r])]
        b3[2, 5000:5100] = ord("N")
        long_reads = torch.from_numpy(b3).to(device)
        long_lens = torch.from_numpy(lengths3).to(device)
        for k in (21, 11):
            subj = subject_sets(genomes, k)
            words, valid = kmers(f"[{B}, 32768], 3 long reads,", long_reads, k)
            routes = [tsr.build_hash_tables(subj, k, device)]
            if k <= 13:
                routes.append(tsr.build_lut_tables(subj, k, device))
            for tables in routes:
                counts(f"[{B}, 32768], 3 long reads, k={k}", words, valid, long_lens, tables,
                       True)
        del routes, words, valid, long_reads
        torch.cuda.empty_cache()

    # Rows on both sides of the tile size in one batch: 0, 1, 2^14 - 1, 2^14,
    # 2^14 + 1 and 2^15 - k + 1 valid words (no N: every window valid), and
    # two merge levels above a tile (a 2^16 bucket).
    tile = tsr.MAX_SHARED_WORDS
    for k in (21, 11, 32):
        subj = subject_sets(genomes, k)
        routes = [tsr.build_hash_tables(subj, k, device)]
        if k <= 13:
            routes.append(tsr.build_lut_tables(subj, k, device))
        for L, row_lens in ((1 << 15, [0, k, tile + k - 2, tile + k - 1, tile + k, 1 << 15, 150]),
                            (1 << 16, [1 << 16, 40_000, 0, tile + k - 1])):
            b4 = np.zeros((len(row_lens), L), np.uint8)
            for r, n in enumerate(row_lens):
                b4[r, :n] = ACGT[np.resize(genomes[r], n) if r % 2 == 0
                                 else rng.integers(0, 4, size=n)]
            lens_t = torch.tensor(row_lens, dtype=torch.int32, device=device)
            words, valid = tk.canonical_kmers(torch.from_numpy(b4).to(device), k)
            for tables in routes:
                counts(f"mixed rows {row_lens} in [{len(row_lens)}, {L}] k={k}", words, valid,
                       lens_t, tables, False)
        del routes, words, valid
        torch.cuda.empty_cache()

    # The LUT / hash crossover at k = 11: one group of 32 subjects holding
    # n k-mers in all; the reads of the phase-8 batch.
    k = 11
    words, valid = tk.canonical_kmers(reads, k)
    out = torch.empty((512, 34), dtype=torch.int32, device=device)
    cross = []
    for n in (8192, 65536, 262144, 1 << 20):
        pool = rng.choice(1 << (2 * k), size=n, replace=False).astype(np.uint64)
        owner = rng.integers(0, 32, size=n)
        subj = [(f"s{i}", np.sort(pool[owner == i])) for i in range(32)]
        times = []
        for tables in (tsr.build_lut_tables(subj, k, device),
                       tsr.build_hash_tables(subj, k, device)):
            got = tsr.sriracha_counts(words, valid, lens, tables, out)
            check(torch.equal(got, tsr.sriracha_counts_ref(words, valid, lens, tables)),
                  f"sriracha_counts_{tables.route} differs at n={n}")
            launch = tsr.counts_launch(words, valid, lens, tables, out, None)
            times.append(cuda_ms(lambda: kernels.launch(*launch), 20))
            del tables
        cross.append(f"n={n}: lut {times[0]:.4f} ms, hash {times[1]:.4f} ms")
    lines.append("sriracha crossover [512, 256] k=11, 32 subjects: " + "; ".join(cross))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="run phase 6 alone and break the ingest call down")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    device = resolve_device("cuda")
    card = card_identity()
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"build: {os.path.relpath(lib)} in {time.perf_counter() - t0:.1f} s; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}; {card}", flush=True)
    t0 = time.perf_counter()
    check(native_available(), "the host library (native/kwage_native.cpp, g++) did not build")
    print(f"build: host library in {time.perf_counter() - t0:.1f} s", flush=True)

    if args.profile:
        with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
            run_ingest(work, device, INGEST, args.seed, profile=True)
        with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
            run_sriracha(work, device, args.seed, profile=True)
        print(card)
        return 0

    # Each path runs with the launch counts zeroed just before it and read
    # just after; phase 4's comparison launches are not counted.
    paths = {}
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        kernels.reset_launch_counts()
        run_main_path(work, device, NUM_FILTER, LOG2_FILTER_LEN, COPIES, args.seed)
        paths["search"] = kernels.launch_counts()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        kernels.reset_launch_counts()
        shapes = run_ingest(work, device, INGEST, args.seed)
        paths["ingest"] = kernels.launch_counts()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    run_entry(device)
    paths["entry"] = kernels.launch_counts()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        kernels.reset_launch_counts()
        run_sriracha(work, device, args.seed)
        paths["sriracha"] = kernels.launch_counts()
    torch.cuda.empty_cache()

    results = phase_kernels(device, args.seed, shapes)
    for path, names in PATH_KERNELS.items():
        check(all(paths[path][k] > 0 for k in names),
              f"a kernel of the {path} path was never launched: {paths[path]}")
    launches = {k: sum(p[k] for p in paths.values()) for k in REPLACES}
    check(all(launches[k] > 0 for k in REPLACES), f"a kernel was never launched: {launches}")
    print("phase 5 counts: " + "; ".join(
        f"{path} {{{', '.join(f'{k}: {paths[path][k]}' for k in names)}}}"
        for path, names in PATH_KERNELS.items()), flush=True)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kwage_tpu"))
    check(not loaded, f"jax or kwage_tpu was imported: {loaded}")

    # One line a kernel: its shape on the main path, its time beside its
    # bound there, and its launches on each path.
    for k in REPLACES:
        r = results[k]
        print(json.dumps({
            "kernel": k, "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "bytes": r["bytes"],
            "operations": r["operations"], "share_of_bound": r["bound_ms"] / r["ms"],
            "library_ms": None,
            "launches": {path: counts[k] for path, counts in paths.items() if counts[k]}}))
    print(card)
    # library_ms: no single PyTorch call computes any of these functions.
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"], "bound_by": results[k]["bound_by"],
         "library_ms": None} for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
