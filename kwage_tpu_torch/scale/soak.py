"""Randomized parity soak: the port's counterpart of ``tools/soak_parity.py``.

    python3 -m kwage_tpu_torch.scale.soak [rounds] [seed_base]

Rounds 5 and base 1000 by default. Round ``seed`` draws from
``default_rng(seed)`` exactly what the JAX tool draws: k in {11, 19, 23,
27, 31, 32}, L ranges (min 10-13, max 16-20), a false-positive target, a
min count of 1 or 2, 2-6 accessions of 1-11 genome-sampled reads (with
Ns), three queries, a threshold in {1, 0.9, 0.5, 0.2} and an output format
(JSON or CSV). Each accession is built on the host (the reference's
counting filter) and on the device (exact counts); the host's .bloom
files pack into one .db a shape. A round fails when

- a device filter differs from the exact ground truth of its reads (the
  host's filter may legitimately differ: its counting filter
  approximates, as the reference's does);
- ``kwage-torch --device`` output differs from the host engine's bytes;
- the reference ``kwage`` (where it is built) differs from the host engine.

Runs on the card unless ``KWAGE_TORCH_DEVICE=cpu`` and raises without
one. Prints each failure as the JAX tool does, ``soak complete: N
rounds, F failures`` and one JSON summary line; exits 1 on any failure.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

from ..cli.kwage import main as kwage_main
from ..core import FilterInfo, str_to_accession
from ..core.words import canonical_kmers
from ..io.bloom_file import write_bloom_file
from ..io.sequence import iter_sequences
from ..native import murmur32_native
from ..pipeline.build_db import build_db_from_bloom_files
from ..pipeline.make_bloom import (
    BloomInvalid,
    BuildOptions,
    build_bloom_device,
    build_bloom_from_file,
)
from ..utils.runtime import resolve_device
from . import _corpus


def exact_image(fasta: str, k: int, min_count: int, param) -> bytes:
    """The exact ground truth of one accession's filter at ``param``: every
    canonical k-mer of its reads counted, those seen ``min_count`` times
    or more hashed into a packed LSB-first image."""
    cnt = Counter()
    for _, q in iter_sequences(fasta):
        cnt.update(canonical_kmers(q, k).tolist())
    words = np.array(sorted(w for w, c in cnt.items() if c >= min_count), dtype=np.uint64)
    gt = np.zeros(param.filter_len // 8, dtype=np.uint8)
    if words.size:
        h = murmur32_native(words, k, param.num_hash)
        idx = (h & np.uint32(param.filter_len - 1)).reshape(-1).astype(np.uint64)
        np.bitwise_or.at(gt, (idx >> 3).astype(np.int64),
                         np.uint8(1) << (idx & 7).astype(np.uint8))
    return gt.tobytes()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def kwage_reference(args: list[str], out: str) -> None:
    """The reference kwage writing ``out``. It can exit 0 without output
    under load (a failed FindFiles walk empties its file list and it quits
    with a stderr line): retried once, then an error."""
    for attempt in range(2):
        proc = subprocess.run([_corpus.oracle_binary("kwage")] + args + ["-o", out],
                              check=True, capture_output=True)
        if os.path.exists(out):
            return
        print(f"reference kwage wrote no output (attempt {attempt}); "
              f"stderr={proc.stderr[-300:]!r}", flush=True)
        time.sleep(1.0)
    raise RuntimeError("reference kwage produced no output after a retry")


def run_round(seed: int, work: str) -> dict:
    """One round in ``work`` (a directory whose path holds no ".db": both
    engines skip databases under such a name, as the reference does).
    Returns {"failures": [...], "opts": the BuildOptions, "dbs": [...],
    "args": the kwage arguments (None when no accession built)}."""
    rng = np.random.default_rng(seed)
    k = int(rng.choice([11, 19, 23, 27, 31, 32]))
    min_l = int(rng.integers(10, 14))
    max_l = int(rng.integers(16, 21))
    fp = float(rng.choice([0.05, 0.25, 0.5]))
    mc = int(rng.choice([1, 1, 2]))
    opts = BuildOptions(kmer_len=k, min_kmer_count=mc, false_positive_probability=fp,
                        min_log_2_filter_len=min_l, max_log_2_filter_len=max_l,
                        min_log_2_count_len=12, max_log_2_count_len=max_l)
    failures: list[str] = []
    groups: dict = {}
    seqs: dict = {}
    for i in range(int(rng.integers(2, 7))):
        acc = f"SRR{seed}{i:02d}"
        glen = int(rng.integers(300, 3000))
        g = "".join(rng.choice(list("ACGTN"), p=[.245, .245, .245, .245, .02], size=glen))
        parts = []
        for _ in range(int(rng.integers(1, 12))):
            st = int(rng.integers(0, max(1, glen - 150)))
            parts.append(g[st:st + int(rng.integers(40, 150))])
        seqs[acc] = g
        fa = os.path.join(work, f"{acc}.fasta")
        with open(fa, "w") as f:
            for j, p in enumerate(parts):
                f.write(f">r{j}\n{p}\n")
        try:
            rec = build_bloom_from_file(fa, opts, FilterInfo(run_accession=str_to_accession(acc)))
        except BloomInvalid:
            continue  # e.g. every read shorter than k
        try:
            dev = build_bloom_device((q for _, q in iter_sequences(fa)), opts,
                                     FilterInfo(run_accession=str_to_accession(acc)))
        except BloomInvalid:
            dev = None  # the exact count may be zero where the host's is not
        if dev is not None and dev.bits.tobytes() != exact_image(fa, k, mc, dev.param):
            failures.append(f"SEED {seed}: device filter != exact ground truth acc={acc} k={k}")
        bl = os.path.join(work, f"{acc}.bloom")
        write_bloom_file(bl, rec)
        groups.setdefault(rec.param, []).append(bl)
    dbs = []
    for gi, (param, paths) in enumerate(sorted(groups.items())):
        dbs.append(os.path.join(work, f"sra.{gi}.db"))
        build_db_from_bloom_files(dbs[-1], param, paths)
    if not dbs:
        return {"failures": failures, "opts": opts, "dbs": dbs, "args": None}
    qf = os.path.join(work, "q.fasta")
    with open(qf, "w") as f:
        for i, (acc, g) in enumerate(list(seqs.items())[:3]):
            st = int(rng.integers(0, max(1, len(g) - 100)))
            f.write(f">q{i}\n{g[st:st + 90]}\n")
    t = float(rng.choice([1, 0.9, 0.5, 0.2]))
    fmt = str(rng.choice(["o.json", "o.csv"]))
    args = [a for d in dbs for a in ("-d", d)] + ["-i", qf, "-t", str(t), f"--{fmt}"]
    outs = {}
    for name, extra in (("host", []), ("device", ["--device"])):
        outs[name] = os.path.join(work, f"{name}.out")
        if kwage_main(args + ["-o", outs[name]] + extra) != 0:
            raise RuntimeError(f"kwage-torch {name} exited non-zero")
    host = _read(outs["host"])
    if _read(outs["device"]) != host:
        failures.append(f"SEED {seed}: DEVICE mismatch k={k} t={t} {fmt}")
    if _corpus.oracle_binary("kwage"):
        kwage_reference(args, os.path.join(work, "o.out"))
        if _read(os.path.join(work, "o.out")) != host:
            failures.append(f"SEED {seed}: HOST mismatch k={k} t={t} {fmt}")
    return {"failures": failures, "opts": opts, "dbs": dbs, "args": args}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0]) if argv else 5
    base = int(argv[1]) if len(argv) > 1 else 1000
    device = resolve_device()
    fails = 0
    t0 = time.perf_counter()
    for seed in range(base, base + rounds):
        work = tempfile.mkdtemp(prefix="soak_")
        try:
            for line in run_round(seed, work)["failures"]:
                print(line, flush=True)
                fails += 1
        except Exception as e:  # noqa: BLE001 -- a round's error is counted, not fatal
            print(f"SEED {seed}: round error: {type(e).__name__}: {e}", flush=True)
            fails += 1
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(f"soak complete: {rounds} rounds, {fails} failures")
    print(json.dumps({"phase": "soak", "rounds": rounds, "seed_base": base,
                      "failures": fails, "device": str(device),
                      "oracle": "present" if _corpus.oracle_binary("kwage") else "absent",
                      "dt_sec": time.perf_counter() - t0,
                      "peak_rss_mb": round(_corpus.peak_rss_mb(), 1),
                      "peak_device_bytes": _corpus.peak_device_bytes(device)}), flush=True)
    return 0 if fails == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
