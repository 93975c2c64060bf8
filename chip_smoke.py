#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (kwage_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

The data is the reference's quota file shape: 2048 Bloom filters per .db
(k=31, 5 hashes) at L=22, so one .db is 1 GiB; 8 copies of it fuse to
W=512 words, 8 GiB on the device (the bench's fused shape). Everything is
made from ``--seed``. Phases, one line each; any failure raises and exits
non-zero:

1. build   -- 2048 .bloom files (random bits at ~50% fill; a few filters
              also hold every k-mer of a planted sequence) packed to .db by
              the port's device transpose; its sha256 must equal the host
              builder's.
2. search  -- the port's ``kwage --device`` over the fused copies with 64
              queries, at -t 1.0 and -t 0.5: output bytes must equal the
              host engine's, and the hits must be exactly the planted ones.
3. serve   -- the port's SearchServer(engine="device") answers the same
              requests over loopback; the bytes must equal phase 2's.
4. kernels -- every kernel against its plain PyTorch version on the card,
              bit for bit, at the main path's shapes and at R*W > 2^31
              words; CUDA-event times of both.
5. counts  -- every kernel was launched by phases 1-3.

It ends with the card's name and power limit, one JSON line of kernels and
the line {"ok": true, "device": {...}}. Without a CUDA device it exits 1.
The kernels build from kwage_tpu_torch/csrc into build/kwage_tpu_torch/.
"""

from __future__ import annotations

import argparse
import collections
import csv
import hashlib
import io
import json
import os
import socket
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from kwage_tpu.cli.kwage import main as host_kwage_main
from kwage_tpu.core import FilterInfo, str_to_accession
from kwage_tpu.core.params import BloomParam
from kwage_tpu.core.words import canonical_kmers
from kwage_tpu.io.bloom_file import BloomFilterRecord, write_bloom_file
from kwage_tpu.native import murmur32_native
from kwage_tpu.pipeline.build_db import build_db_from_bloom_files as host_build_db
from kwage_tpu_torch import kernels
from kwage_tpu_torch.cli.kwage import main as torch_kwage_main
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.ops import transpose as tt
from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files
from kwage_tpu_torch.search.resident import SearchServer
from kwage_tpu_torch.utils.runtime import card_identity, resolve_device

NUM_FILTER = 2048          # the reference's quota file (options.h:137-157)
LOG2_FILTER_LEN = 22
KMER_LEN = 31
NUM_HASH = 5
COPIES = 8                 # fused .db copies in phases 2-3 (bench.py:42-47)
N_PLANTED = 16             # planted sequences, each held by 3 filters
CASES = [(1.0, "csv"), (0.5, "csv"), (0.5, "json")]  # (threshold, format)
# The TPU kernel each CUDA kernel replaces.
REPLACES = {
    "bit_transpose": "kwage_tpu/ops/transpose.py:96",
    "search_complete": "kwage_tpu/ops/search.py:88",
    "search_counts": "kwage_tpu/ops/search.py:136",
}
SOURCES = {
    "bit_transpose": "kwage_tpu_torch/csrc/bit_transpose.cu",
    "search_complete": "kwage_tpu_torch/csrc/search.cu",
    "search_counts": "kwage_tpu_torch/csrc/search.cu",
}


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
    host_build_db(host_db, param, blooms)
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
                                  ("host", host_kwage_main, [])):
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
    print(f"phase 2 search: {len(queries)} queries x {copies} fused files "
          f"(W={copies * ((n_filter + 31) // 32)}), bytes == host engine, "
          f"{n_hits} planted hits at -t 0.5; {'; '.join(times)}", flush=True)

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


def phase_kernels(device: torch.device, seed: int) -> list[dict]:
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
    results["bit_transpose"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain}
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
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain}
            else:
                prev["max_abs_err"] = max(prev["max_abs_err"], err)
        del db, idx, valid
        torch.cuda.empty_cache()
    print("phase 4 kernels == plain versions, bit for bit: " + "; ".join(lines), flush=True)
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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

    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        run_main_path(work, device, NUM_FILTER, LOG2_FILTER_LEN, COPIES, args.seed)
    launches = kernels.launch_counts()
    torch.cuda.empty_cache()

    results = phase_kernels(device, args.seed)
    check(all(launches[k] > 0 for k in REPLACES),
          f"a kernel of the main path was never launched: {launches}")
    print(f"phase 5 counts: main-path launches {launches}", flush=True)
    check("jax" not in sys.modules, "jax was imported")

    print(card)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], **results[k]} for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
