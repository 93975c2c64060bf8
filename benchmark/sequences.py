"""Sequences drawn from ``--seed``: lineage genomes, each run's substitutions,
and the queries of every request (NumPy only, so the client process draws
the same requests as the process that checks them).

A configuration's runs come in lineages: run r belongs to lineage
r // runs_per_lineage, and its genome is the lineage's genome with
round(run_substitution_rate x genome_len) bases changed, one in each of that
many equal strata of the genome (so the positions are distinct). A traffic mix's queries are
drawn per request index j from its own stream, so request j is the same in
every run of one seed, whichever client sends it.
"""

from __future__ import annotations

import numpy as np

from .reference.kmers import decode

_LINEAGES, _SUBS, _REQUESTS, _WARMUP, _SWEEP = 1, 2, 3, 4, 8


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


def genomes(cfg: dict, seed: int) -> np.ndarray:
    """Lineage genomes, base codes uint8 [lineages, genome_len]."""
    return rng(seed, _LINEAGES).integers(0, 4, size=(cfg["lineages"], cfg["genome_len"]),
                                         dtype=np.uint8)


def strata(length: int, count: int, g: np.random.Generator, rows: int) -> np.ndarray:
    """int64 [rows, count]: one position a stratum, ``count`` equal strata
    of ``length``, ascending and distinct in each row."""
    edges = (np.arange(count + 1, dtype=np.int64) * length) // count
    width = edges[1:] - edges[:-1]
    return edges[:-1] + (g.random((rows, count)) * width).astype(np.int64)


def run_substitutions(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions int64 [runs, S], base deltas uint8 [runs, S] in 1..3): run
    r's genome is its lineage's with base p -> (base + delta) % 4."""
    g = rng(seed, _SUBS)
    runs = cfg["files"] * cfg["filters_per_file"]
    count = round(cfg["run_substitution_rate"] * cfg["genome_len"])
    pos = strata(cfg["genome_len"], count, g, runs)
    delta = g.integers(1, 4, size=pos.shape, dtype=np.uint8)
    return pos, delta


def request(mix: dict, lineage_genomes: np.ndarray, seed: int, j: int,
            warmup: bool = False) -> list[str]:
    """The queries of request ``j`` of traffic mix ``mix``."""
    g = rng(seed, _WARMUP if warmup else _REQUESTS, j)
    q = mix["queries_per_request"]
    n_lin, length = lineage_genomes.shape
    kind = mix["query"]
    out = []
    if kind == "isolate":
        for _ in range(q):
            out.append(isolate(mix, lineage_genomes, int(g.integers(n_lin)), g))
    elif kind == "slice":
        lo, hi = mix["min_len"], mix["max_len"]
        # The same lengths in every request (an even grid), in a drawn order.
        lens = lo + ((np.arange(q) + 0.5) * (hi - lo) / q).astype(np.int64)
        lens = g.permutation(lens)
        miss = mix.get("miss_every", 0)
        for i, n in enumerate(lens):
            if miss and i % miss == miss - 1:
                out.append(decode(g.integers(0, 4, size=n, dtype=np.uint8)))
            else:
                seq = lineage_genomes[g.integers(n_lin)]
                s = int(g.integers(0, length - n + 1))
                out.append(decode(seq[s : s + n]))
    else:
        raise ValueError(f"unknown query kind {kind!r}")
    return out


def isolate(mix: dict, lineage_genomes: np.ndarray, lineage: int,
            g: np.random.Generator) -> str:
    """A lineage's genome with isolate_substitution_rate of its bases
    substituted (one in each of that many strata)."""
    seq = lineage_genomes[lineage].copy()
    subs = round(mix["isolate_substitution_rate"] * seq.shape[0])
    pos = strata(seq.shape[0], subs, g, 1)[0]
    seq[pos] = (seq[pos] + g.integers(1, 4, size=subs, dtype=np.uint8)) % 4
    return decode(seq)


def sweep(mix: dict, lineage_genomes: np.ndarray, seed: int) -> list[list[str]]:
    """The requests of a mix's ``warmup_sweep``: a ``slice_len`` slice of
    every lineage's genome once, ``queries_per_request`` to a request, in a
    drawn order. At the sweep's threshold every run of a lineage holds
    enough of the slice's k-mers (a run differs from its lineage at 0.1% of
    bases), so the sweep touches every run of the corpus."""
    sw = mix["warmup_sweep"]
    g = rng(seed, _SWEEP)
    n_lin, length = lineage_genomes.shape
    qs = []
    for lin in g.permutation(n_lin):
        s = int(g.integers(0, length - sw["slice_len"] + 1))
        qs.append(decode(lineage_genomes[lin, s : s + sw["slice_len"]]))
    n = sw["queries_per_request"]
    return [qs[i : i + n] for i in range(0, len(qs), n)]


def accession(run: int) -> str:
    """The run accession of run ``run`` of a corpus."""
    return f"SRR{1000000 + run}"
