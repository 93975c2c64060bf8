"""What the scale programs share: the seeded corpora of the JAX tools, the
phase logger, the quota table, the machine check and the exact ground
truth of a built accession.

The corpus is the JAX tools' own (``tools/run_at_scale.py:84-111``,
``tools/run_at_scale_prodL.py:97-120``): for each accession a random
genome of ``genome_bp`` bases and ``genome_bp * coverage // READ_LEN``
reads of READ_LEN bases at random starts, one FASTA record a read, every
draw from one ``default_rng(seed)`` in the same order, so the same seed
and knobs give the same bytes; a 400 bp slice (bases 1000-1400) of the
genomes at the ``query_at`` indices is the query set. The distributed
proof's corpus (``generate_dscale``) is that tool's own: Python's
``random.Random(20260818)``, records of up to 3000 bases.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import resource
import shutil

import numpy as np
import torch

from ..bench._common import exact_bloom
from ..core import FilterInfo, str_to_accession
from ..core.params import filters_per_file_quota
from ..io.bloom_file import read_bloom_file
from ..io.inventory import write_inventory

READ_LEN = 160
K = 31
# Where the reference binaries are built (tests/golden/README.md), if they are.
ORACLE = "/tmp/oracle"
_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Corpus:
    src: str                          # one <accession>.fasta a run
    inv: str                          # the inventory (FilterInfo records)
    accessions: list[str]
    bp_per_acc: int
    queries: list[tuple[str, str]]    # (accession, 400 bp of its genome)


def generate(work: str, n_acc: int, genome_bp: int, coverage: int, seed: int,
             prefix: str, query_at: tuple[int, ...]) -> Corpus:
    """Write the JAX tools' corpus under ``work`` (``fa/`` and ``inv.bin``)."""
    rng = np.random.default_rng(seed)
    src = os.path.join(work, "fa")
    os.makedirs(src)
    accs = [f"{prefix}{i:06d}" for i in range(n_acc)]
    n_reads = genome_bp * coverage // READ_LEN
    infos, queries = [], []
    for ai, acc in enumerate(accs):
        genome = _LUT[rng.integers(0, 4, size=genome_bp, dtype=np.uint8)]
        starts = rng.integers(0, genome_bp - READ_LEN + 1, size=n_reads)
        parts = []
        for r, st in enumerate(starts):
            parts.append(b">r%d\n" % r)
            parts.append(genome[st:st + READ_LEN].tobytes())
            parts.append(b"\n")
        with open(os.path.join(src, f"{acc}.fasta"), "wb") as f:
            f.write(b"".join(parts))
        infos.append(FilterInfo(run_accession=str_to_accession(acc),
                                number_of_bases=n_reads * READ_LEN))
        if ai in query_at:
            queries.append((acc, genome[1000:1400].tobytes().decode()))
    inv = os.path.join(work, "inv.bin")
    write_inventory(inv, infos)
    return Corpus(src, inv, accs, n_reads * READ_LEN, queries)


# The distributed proof's corpus (tools/run_at_scale_distributed.py:165-177).
DSCALE_SEED = 20260818
DSCALE_RECORD = 150 * 20   # bases a FASTA record holds at most


def _choices_acgt(rng: random.Random, n: int) -> np.ndarray:
    """``n`` draws of ``rng.choice("ACGT")`` as codes 0-3, leaving ``rng``
    where those calls would. ``choice`` of 4 items draws
    ``getrandbits(3)`` (the top 3 bits of one 32-bit word) and draws again
    above 3; so the draws are the top 3 bits
    of the next words, those above 3 skipped. The words come in bulk
    (``getrandbits``, first word lowest), then the generator is set back
    and advanced by the words the n draws used."""
    parts, have = [], 0
    while have < n:
        need = n - have
        m = 2 * need + 64
        state = rng.getstate()
        top = np.frombuffer(rng.getrandbits(32 * m).to_bytes(4 * m, "little"),
                            dtype=np.uint32) >> np.uint32(29)
        ok = np.flatnonzero(top < 4)
        if ok.size >= need:
            rng.setstate(state)
            rng.getrandbits(32 * int(ok[need - 1] + 1))
            ok = ok[:need]
        parts.append(top[ok])
        have += ok.size
    return np.concatenate(parts) if parts else np.zeros(0, np.uint32)


@dataclasses.dataclass
class DscaleCorpus:
    src: str                          # one <accession>.fasta a run
    inv: str                          # the inventory
    accessions: list[str]
    infos: list[FilterInfo]
    queries: list[tuple[str, str]]    # (q<i>, the first 200 bases of a run's first record)


def generate_dscale(work: str, n_acc: int, genome_bp: int, coverage: int) -> DscaleCorpus:
    """Write the distributed proof's corpus under ``work`` (``src/`` and
    ``inventory.bin``), byte for byte the JAX tool's: one
    ``random.Random(20260818)``; for SRR9000000 + i a genome of
    ``genome_bp`` ``rng.choice("ACGT")`` bases, then ``coverage`` records of
    up to 3000 bases from ``rng.randrange(0, genome_bp - 150)``; then 4
    queries, the first 200 bases of a random accession's first record."""
    rng = random.Random(DSCALE_SEED)
    src = os.path.join(work, "src")
    os.makedirs(src, exist_ok=True)
    accs, infos = [], []
    for i in range(n_acc):
        acc = f"SRR{9000000 + i}"
        g = _LUT[_choices_acgt(rng, genome_bp)].tobytes().decode()
        with open(os.path.join(src, acc + ".fasta"), "w") as f:
            for r in range(coverage):
                a = rng.randrange(0, max(1, genome_bp - 150))
                f.write(f">r{r}\n{g[a:a + DSCALE_RECORD]}\n")
        accs.append(acc)
        infos.append(FilterInfo(run_accession=str_to_accession(acc),
                                number_of_bases=genome_bp * coverage))
    inv = os.path.join(work, "inventory.bin")
    write_inventory(inv, infos)
    queries = []
    for i in range(4):
        with open(os.path.join(src, f"SRR{9000000 + rng.randrange(n_acc)}.fasta")) as g:
            g.readline()
            queries.append((f"q{i}", g.readline().strip()[:200]))
    return DscaleCorpus(src, inv, accs, infos, queries)


def write_queries(path: str, queries: list[tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for acc, q in queries:
            f.write(f">{acc}\n{q}\n")


def fasta_reads(path: str) -> np.ndarray:
    """The records of a corpus FASTA (one line a sequence) as ASCII uint8
    [n, the longest]: READ_LEN wide for the seeded corpus; a shorter record
    (the distributed proof's) padded with N, which no k-mer spans."""
    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::2]
    width = max(map(len, seqs), default=0)
    return np.frombuffer(b"".join(s.ljust(width, b"N") for s in seqs),
                         dtype=np.uint8).reshape(len(seqs), width)


def bloom_matches_truth(bloom_path: str, fasta_path: str, min_count: int,
                        min_log2_len: int, max_log2_len: int) -> bool:
    """A device-built .bloom equals the exact ground truth of its reads:
    the words seen ``min_count`` times or more, hashed into the adaptive
    shape (``bench._common.exact_bloom``)."""
    rec = read_bloom_file(bloom_path)
    param, bits, _ = exact_bloom(fasta_reads(fasta_path), K, min_count,
                                 min_log_2_filter_len=min_log2_len,
                                 max_log_2_filter_len=max_log2_len)
    return rec.param == param and rec.bits.tobytes() == bits.tobytes() and rec.test_crc32()


def peak_rss_mb() -> float:
    """Peak resident set of this process, MB. Its children are left out (the
    JAX tools add them): a child forked for the kernel build reports the
    parent's peak at the fork as its own, which the sum would count twice."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def peak_device_bytes(device: torch.device) -> int | None:
    """Peak device memory allocated since the last reset (None off a card)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def rss_now_mb() -> float:
    """This process's resident memory now (VmRSS), MB. A phase's peak above
    it is memory the phase let go of: the .db files' mapped pages, which the
    search paths read through mmap and unmap at the end of each call."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return round(int(line.split()[1]) / 1024, 1)
    raise RuntimeError("no VmRSS in /proc/self/status")


class PhaseLog:
    """One JSON line a phase, with the peak host RSS so far, the resident
    memory now and the peak device memory of the phase (the count is reset
    after each line); ``stamp`` (the card's identity, say) goes into every
    line."""

    def __init__(self, device: torch.device, stamp: dict | None = None):
        self.device = device
        self.stamp = stamp or {}
        self.results: list[dict] = []
        if device.type == "cuda":
            torch.cuda.init()   # the memory statistics need the allocator up
            torch.cuda.reset_peak_memory_stats(device)

    def log(self, phase: str, **kw) -> dict:
        rec = {"phase": phase, **kw, **self.stamp, "peak_rss_mb": round(peak_rss_mb(), 1),
               "rss_now_mb": rss_now_mb(),
               "peak_device_bytes": peak_device_bytes(self.device)}
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        print(json.dumps(rec), flush=True)
        self.results.append(rec)
        return rec

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.results, f, indent=1)


def quota_table(lo: int = 24, hi: int = 32) -> dict[str, int]:
    """Filters a .db file may hold at each L (options.h:137-138: min(2048,
    64 GiB * 8 / 2^L)), with the production lengths' values asserted."""
    table = {str(L): filters_per_file_quota(L) for L in range(lo, hi + 1)}
    if (filters_per_file_quota(26), filters_per_file_quota(29),
            filters_per_file_quota(32)) != (2048, 1024, 128):
        raise RuntimeError(f"quota table {table} is not the reference's")
    return table


def available_ram_bytes() -> int:
    """Host memory available to new allocations (MemAvailable)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def require_machine(work: str, disk_bytes: int, ram_bytes: int) -> dict:
    """Fail, naming the shortfall, unless ``work`` has ``disk_bytes`` free
    and the host ``ram_bytes`` available; returns what there is."""
    disk = shutil.disk_usage(work).free
    ram = available_ram_bytes()
    short = []
    if disk < disk_bytes:
        short.append(f"{disk / 2**30:.1f} GiB free on {work}, {disk_bytes / 2**30:.0f} GiB needed")
    if ram < ram_bytes:
        short.append(f"{ram / 2**30:.1f} GiB of host memory available, "
                     f"{ram_bytes / 2**30:.0f} GiB needed")
    if short:
        raise RuntimeError("machine too small: " + "; ".join(short))
    return {"disk_free_bytes": disk, "ram_available_bytes": ram}


def oracle_binary(name: str) -> str | None:
    """The reference binary ``name`` where it is built, else None."""
    path = os.path.join(ORACLE, name)
    return path if os.path.isfile(path) else None
