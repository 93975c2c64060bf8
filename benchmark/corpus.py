"""The searched corpus of a configuration, built on the device from the seed.

Run r's filter holds the canonical k-mers of its genome (lineage genome plus
its substitutions, ``sequences``), each set at ``num_hash`` murmur3 rows, as
a Bloom filter of 2^L bits (error-free reads above ``min_kmer_count``: every
k-mer of the genome, no other). The rows of a lineage's k-mers are hashed
once; a run hashes again only the windows its substitutions touch. The
filters of a file are set in a bool matrix [2^L, F] and packed LSB-first
into the file's slices. Files are written by ``dbfile`` on a writer thread
while the card builds the next one.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import dbfile, sequences
from .reference.kmers import canonical_torch, window_words
from .reference.murmur import murmur_torch
from .reference.search import SearchReference

# int64 entries a step of the bit set holds: [runs, windows, num_hash].
STEP_ENTRIES = 1 << 27


def file_runs(cfg: dict, f: int) -> range:
    return range(f * cfg["filters_per_file"], (f + 1) * cfg["filters_per_file"])


def _file_slices(cfg, f, lineage_d, base_rows, sub_pos, sub_delta) -> torch.Tensor:
    """uint8 [2^L, F / 8] slices of file ``f`` on the device."""
    k, nh, L = cfg["k"], cfg["num_hash"], cfg["log2_filter_len"]
    F, rpl = cfg["filters_per_file"], cfg["runs_per_lineage"]
    device = lineage_d.device
    nwin = lineage_d.shape[1] - k + 1
    bits = torch.zeros(((1 << L) * F,), dtype=torch.bool, device=device)
    step = max(1, STEP_ENTRIES // (nwin * nh))
    runs = file_runs(cfg, f)
    for r0 in range(runs.start, runs.stop, step):
        r = torch.arange(r0, min(r0 + step, runs.stop), device=device)
        lin = r // rpl
        rows = base_rows[lin]                                  # [C, nwin, nh]
        genome = lineage_d[lin]                                # [C, G]
        pos, delta = sub_pos[r], sub_delta[r]                  # [C, S]
        at = torch.arange(len(r), device=device)[:, None]
        genome[at, pos] = (genome[at, pos] + delta) % 4
        # The windows a substitution touches, hashed again from the run's genome.
        w = pos[:, :, None] - torch.arange(k, device=device)  # [C, S, k]
        keep = (w >= 0) & (w < nwin)
        w = w[keep]
        run_of = at[:, :, None].expand(keep.shape)[keep]
        words = window_words(genome, run_of, w, k)
        rows[run_of, w] = (murmur_torch(words, k, nh) & ((1 << L) - 1)).to(torch.int32)
        col = (r - runs.start)[:, None, None]
        bits[rows.to(torch.int64) * F + col] = True
    bits = bits.view(1 << L, F // 8, 8).to(torch.uint8)
    packed = bits[:, :, 0].clone()
    for b in range(1, 8):
        packed |= bits[:, :, b] << b
    return packed


def build(cfg: dict, seed: int, workdir: str, device: torch.device) -> list[str]:
    """Write the configuration's .db files under ``workdir`` (file order =
    corpus order) and return their paths."""
    k, nh, L = cfg["k"], cfg["num_hash"], cfg["log2_filter_len"]
    if cfg["filters_per_file"] % 32:
        raise ValueError("filters_per_file must be a multiple of 32")
    lineage_d = torch.from_numpy(sequences.genomes(cfg, seed)).to(device)
    base_rows = (murmur_torch(canonical_torch(lineage_d, k), k, nh)
                 & ((1 << L) - 1)).to(torch.int32)             # [lineages, nwin, nh]
    pos, delta = sequences.run_substitutions(cfg, seed)
    sub_pos = torch.from_numpy(pos).to(device)
    sub_delta = torch.from_numpy(delta).to(device)
    paths = [os.path.join(workdir, f"part{f:04d}.db") for f in range(cfg["files"])]
    with ThreadPoolExecutor(1) as writer:
        pending = []
        for f, path in enumerate(paths):
            slices = _file_slices(cfg, f, lineage_d, base_rows, sub_pos, sub_delta).cpu().numpy()
            names = [sequences.accession(r) for r in file_runs(cfg, f)]
            pending.append(writer.submit(dbfile.write, path, k, nh, L, slices, names))
        for p in pending:
            p.result()
    return paths


def reference(cfg: dict, paths: list[str], device: torch.device) -> SearchReference:
    """The plain search over the files the benchmark wrote, on ``device``."""
    W = len(paths) * cfg["filters_per_file"] // 32
    db = torch.empty((1 << cfg["log2_filter_len"], W), dtype=torch.int32, device=device)
    w0 = 0
    for path in paths:
        words = dbfile.read_slices(path).view(np.int32)
        db[:, w0 : w0 + words.shape[1]] = torch.from_numpy(words).to(device)
        w0 += words.shape[1]
    names = [sequences.accession(r) for r in range(cfg["files"] * cfg["filters_per_file"])]
    return SearchReference(db, names, cfg["k"], cfg["num_hash"], cfg["log2_filter_len"])
