#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (kwage_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Search (phases 1-3): the reference's quota file shape, 2048 Bloom
filters per .db (k=31, 5 hashes) at L=22, so one .db is 1 GiB; 8 copies of
it fuse to W=512 words, 8 GiB on the device (the bench's fused shape).
Ingest (phase 6): 16 FASTQ accessions, 176 Mbp of 150 bp reads. SriRachA
(phase 8): 40 query genomes of 30 kbp against one FASTQ of 1,000,000
150 bp reads and 64 of 20 kbp, and against one of 8,192 reads of 1-16
kbp. Everything is made from ``--seed``. Phases, one line each, then each
phase's wall; any failure raises and exits non-zero:

1. build   -- 2048 .bloom files (random bits at ~50% fill; a few filters
              also hold every k-mer of a planted sequence) packed to .db by
              the port's device transpose; its sha256 must equal the host
              builder's.
2. search  -- the port's ``kwage --device`` over the fused copies with 64
              queries, at -t 1.0 and -t 0.5, by both routes of the device
              search (``gather``: only the slice rows the batch touches go
              to the card; ``full``: the whole chunk, GATHER_SHARE set to
              0): output bytes must equal the host engine's, and the hits
              must be exactly the planted ones. Each device call's route,
              rows, gathered bytes and steps (read, gather, upload, search,
              hit lists) are printed, beside the pinned and the pageable
              host-to-device rate of a 1 GiB copy (CUDA events). Then
              ``search_chunk``'s rule at GATHER_SHARE: 400 bp queries on
              70% of two files' rows, under a budget of an eighth of a file,
              take the full route (the gathered rows' own slabs count),
              with the gather route's hit lists.
3. serve   -- the port's SearchServer(engine="device") answers the same
              requests over loopback; the bytes must equal phase 2's. Then
              a ResidentSearcher under half the corpus's bytes (some files
              resident, the rest streamed per request) renders phase 2's
              bytes by both routes, the gather route's host chunks as
              gathered rows.
6. ingest  -- the port's ``kwage-maestro-torch --device-build
              --device-transpose`` over 14 accessions of a 400 kbp genome at
              15x (fused batch) and 2 of a 4.6 Mbp genome at 10x (chunked),
              k=31, min count 5 (the sort is the radix_sort_pairs kernels: a
              library sort of a CUDA tensor raises during the call, and so
              does a library compaction or run count inside the sort and
              inside the build of a big accession, which counts on the card
              with run_counts): every
              .bloom equals the exact host ground
              truth, every .db the host pack, a ``kwage --device`` search of
              genome reads the host engine's bytes; the golden corpus
              reproduces the golden .db digests.
11. remote -- phase 6's accessions again, through the cross-host work
              queue: ``kwage-maestro-torch --coordinator`` with its 2 local
              pull workers (threads) and one ``kwage-maestro-torch
              --worker`` process, all with --device-build
              --device-transpose on the card: every .bloom and .db equals
              phase 6's bytes (and the ground truth), every accession is
              done; the wall beside phase 6's and each process's peak
              device memory. Phase 6's refusals hold in this process, in
              each worker thread.
12. chunked -- phase 6's two 46 Mbp accessions through build_bloom_device
              from their FASTQ paths and from iterators of their reads,
              forced into chunks of 8 Mbp (the JAX package's chunk_bp; each
              chunk's (word, count) runs merge into an accumulator on the
              card with merge_counts), then in chunks sized from the card,
              then 6 at once in threads on a card with 3 GiB free, then
              both from their paths in each of two processes at once
              (and the same 4 builds in threads of this process), with 3
              GiB free, narrowed round by round until a halving retry
              fires in a child: each record == the exact ground truth,
              under phase 6's refusals; each child's halvings and peak
              device memory; walls beside the native host builder's, and
              the device memory a window of a chunk's count takes (all
              valid too) and a word of a merge, each held to its
              make_bloom constant.
7. entry   -- the port's ``entry()`` forward on the card equals the plain
              versions' result on the CPU.
9. mesh    -- the sharded search (``parallel.sharded_search``) over phase
              1-3's fused files, on logical shards of the card (and on
              every card where there are several): MeshResidentSearcher on
              a 1 x 4 mesh, resident, and on a 2 x 2 mesh; then, under a
              budget of 1 GiB a shard, MeshResidentSearcher on a 1 x 4 mesh
              (the first file chunk resident, the others streamed in waves
              of what is left) and one ``ShardedDatabase.from_files`` over
              all 8 files (one stream of 4 column waves, so a wave reuses
              the buffer an earlier one left); each renders phase 2's
              bytes for every case. ``ShardedDatabase.total_hits`` equals
              the host engine's hit-list lengths a query at -t 1.0 and
              0.5, resident and in waves; the streamed runs' peak device
              memory stays within the budget times the shards on the card,
              and every searcher, dropped, frees its device memory at once
              (allocated memory back to its value before the run).
              Then ``dryrun_multichip(4)``: device ingest + device
              transpose -> .db files + status checkpoint -> the mesh
              search in waves == the host engine.
8. sriracha -- ``kwage-sriracha-torch --device`` twice: (A) k=21, the
              bucketed hash tables, and (B) k=11, the dense LUTs (two
              groups of 32 + 8 subjects, ~1.2 M subject k-mers), t=0.8,
              --max-results 100: each TSV must equal the host engine's
              (the same CLI without ``--device``, in the machine's cores,
              HOST_THREADS) byte for byte, and
              the subjects hit only by 20 kbp reads must list exactly those
              and the five edge reads below;
              the 150 bp reads' batches take the fused sriracha_reads kernel
              of the run's probe and the 20 kbp reads' canonical_kmers and
              sriracha_counts (with five reads of 16385-16405 bp, on both
              sides of 2^14 windows at k = 11 and 21: the rows that
              sriracha_counts' block kernel sorts from words, and the tile
              chain's shortest), and the other probe's kernels never
              launch.
              Mbp/s, the device path's profile and the host's Mbp/s. Then
              twice more, (C) k=21 and (D) k=11, over 8,192 long reads (an
              ONT run's ~1.2 kbp amplicons of the subjects, and genomic
              reads log-uniform in 1-16 kbp, with substitutions, Ns and
              reads on the buckets' edges; 27.6 Mbp): each TSV == the host
              engine's, every subject listed,
              and every batch one launch of the run's sriracha_block
              kernel, with no canonical_kmers, sriracha_counts or
              sriracha_reads launch.
10. sriracha mesh -- phase 8's runs A and B again, through search_reads_device
              on a mesh of 4 logical slots of the card (each batch's reads
              split over the slots, each slot on its own stream; also over
              every card where there are several), then through
              ``kwage-sriracha-torch --device`` with the card listed 4
              times as the visible devices: each TSV equals phase 8's
              bytes; walls, Mbp/s and profiles beside phase 8's.
14. prod-L -- the production filter length at full width: the first 64
              accessions of the JAX prodL corpus (30 kbp genomes at 4x, 160 bp
              reads, k=31, min count 2) through ``kwage-maestro-torch
              --device-build --device-transpose --len.min 26 --len.max 26``
              under phase 6's refusals: every 8 MiB .bloom equals the exact
              ground truth, the partial .db the host pack. Then each .bloom
              listed 32 times packs one full quota file through the device
              transpose (2048 filters, 16 GiB, 32 chunks of 2^21 bits), whose
              sha256 equals the host pack's, computed chunk by chunk and never
              written (each chunk also equal to the file's rows). The two
              files searched by ``kwage-torch --device`` (the gather route:
              the rows the queries touch) at -t 1.0 JSON and -t 0.8 CSV
              == the host engine, each call's route, rows and steps; then
              once more at -t 0.8 by the full route (the 16 GiB file in
              column slabs of the 8 GiB default budget) == the host
              engine, its peak device memory within the budget, with the
              step times and the upload's GB/s;
              complete reads hit their accession's 33 filters; a
              ResidentSearcher (17 GiB budget) holding both (both cases),
              and a MeshResidentSearcher on 4 logical shards of 2 GiB (the
              full file in waves; a render and total_hits at -t 0.8, ==
              the hit-list lengths; peak memory within the budget), each ==
              the host engine and each freeing its memory on del. The machine is checked first (40 GiB free
              in the work directory, 24 GiB of host memory), and a shortfall
              fails the run.
4. kernels -- every kernel against its plain PyTorch version on the card,
              bit for bit, at the paths' shapes and at R*W > 2^31 words
              (search) and num_acc * 2^L >= 2^32 bits (bloom_set_bits);
              CUDA-event times of both. The ingest kernels also at
              k = 15, 16, 31 and 32 on a small block, packed and ASCII, and
              canonical_kmers at k = 1-32 on lengths that end inside a word,
              murmur32 and slice_indices at every k = 1-32 and nh = 1-9.
              select_runs and bit_transpose, which work in tiles, at the
              sizes, runs, accession boundaries, look-aheads and ragged
              widths that meet a tile's edge (``tiled_edge_checks``).
              search_total_hits at the search rows' shape and on a shard
              whose width is no multiple of 32; search_complete also where
              its answer is not trivial (dense rows: words that stay
              all-ones, words that go to 0 and words between, in each
              tile). radix_sort_pairs (both
              entries: all pairs, and the valid windows only) at the fused
              batch's layout (the main path's call), at its window count
              with 30% invalid, and at 2^24 windows, each beside compaction
              + ``torch.sort`` twice over the valid pairs and ``torch.sort``
              twice over all (its plain versions and library yardsticks);
              at k = 15, 16, 32, with 1 and 300 accessions, at sizes around
              its 4096-pair tile, on all-equal and on sorted input.
              select_runs and bloom_set_bits on its outputs: the fused
              batch's valid windows (the main path's input), then all
              pairs at 30% invalid. transpose_bits_device on [2048, 2^17] bytes and with F, B
              and P ragged.
              The SriRachA kernels at phase 8's batch shape (512 x 256,
              k = 11 and 21), on a small block holding every byte value at
              k = 3, 13, 14, 16, 31, 32, on 2^15-base reads in batches of 4
              and 512 rows (canonical_kmers' ASCII entry too, at these
              three shapes), and on rows around the 2^14-word tile; both
              probes timed at 8 k, 64 k, 256 k and 1 M k-mers per group
              (k = 11): the LUT / hash crossover. The fused short-read
              entries (sriracha_reads_lut / _hash) == read_batch_counts_ref
              at 512 x 256 (k = 11, 21), 512 x 128 (k = 21) and 8192 x 256
              (k = 11, 21), each timed beside the two launches they replace
              (canonical_kmers + sriracha_counts) on the same inputs, on the
              every-byte block, on rows of 0, 1, k - 1 and k bases at
              k = 1-32, and in the crossover beside the words route. The
              block entries (sriracha_block_lut / _hash) == the plain
              version at 512 x 2048, 64 x 16384 and 512 x 16384 (1.5 and 15
              kbp reads; k = 11 LUT, k = 21 hash), each timed beside the
              words route, and on edge rows of the 2048 bucket and of 2^14
              + k - 1 bases at k = 3, 13, 14, 16, 31, 32. The words entry
              (sriracha_counts_lut / _hash: its rows of at most 2^14
              windows on the same block kernel, from canonical words; the
              longer ones in tiles) == the plain version at those three
              shapes and the two 2^15-base batches, each timed beside the
              first design's time, and on [8, 32768] rows of 0, k - 1,
              16385, 16384 + k - 1, 16384 + k, 20, 26 and 32 kbp at k = 1,
              3, 11, 13, 14, 16, 17, 21, 31, 32 (timed at k = 11 LUT and
              21 hash), also from words and flags 8 bytes off a 16-byte
              boundary (k = 11, 21, 32). run_counts and
              merge_counts at a 46 Mbp accession's shape and at a real
              accession's (a chunk of 2^27 windows; 2^28 + 2^26 words
              merged), run_counts beside torch.unique_consecutive; at the
              tile edges, on k = 32 signed words, with saturating weights
              and a cap of 40, on inputs off a 16-byte boundary, and on
              empty, disjoint, interleaved and identical runs and runs
              with an equal pair at every tile edge. bloom_set_bits also at
              phase 14's build (its windows, 2^26-bit images), timed.
5. counts  -- every kernel was launched by the path phases (1-3, 9, 6, 12,
              11, 7, 8, 10, 14); the worker process of phase 11 reports its own counts;
              each path's counts are zeroed just before it and read just
              after.
13. bench  -- the bench programs (kwage_tpu_torch.bench), each in a process
              of its own on the card, each exiting 0 only when its own checks
              pass: search at bench.py's full width (2^22 rows x 8 files,
              8 GiB; the kernels == their plain versions, every sample under
              the memory ceiling), build at bench_build.py's defaults (the
              device filters == exact ground truth), SriRachA at its tool's
              defaults and at k=11 on the LUT, serve at 1000 of its 4350
              accessions (the smoke's time; the resident renders == the
              host searcher's); their lines printed.
15. tools -- the JAX package's last programs, each in a process of its
              own on the card at its JAX tool's defaults, each exiting 0
              only when its checks pass: bench.search_phases (2^22 x 512, 8 x
              1024, nh 5: gather1, gather5_and, search_complete,
              search_counts, each == its plain version first),
              bench.sorted_gather, bench.ingest (== the host's exact count),
              bench.build_phases (== exact ground truth), bench.sriracha_model
              (== the host engine), bench.scaling (logical slots of the card
              == one device), scale.distributed (a coordinator and 2
              device worker processes, a single run, a SIGKILLed worker;
              result sets equal, kwage --device == the host engine) at 250
              of its 1000 accessions and without its latency regime
              (SCALE_N_ACC=250, SCALE_SKIP_LATENCY=1: the smoke's time; the
              program runs whole apart), and
              scale.dry_sched (50,000 accessions, no .bloom opened; its
              checkpoints timed), which runs before phase 1, while the disk
              holds nothing yet to write back; each cut, with its output
              printed, where it would pass SMOKE_SECONDS less SMOKE_RESERVE
              from the start; their lines
              printed and their reported launches (the checks' left out)
              counted as the path "tools". Then gather1 and gather5_and
              (csrc/variants/search_phases.cu, built alone beside the
              library) bit for bit against their plain versions at the
              chunked layout's edges; at the main shape, search_phases'
              own check and times.

It ends with one JSON line a kernel (its shape on the main path, its time
beside its bound, its launches on each path; gather1 and gather5_and, which
replace no TPU kernel, name the JAX phase function they stand for), the
card's name and power limit, one JSON line of kernels and the line
{"ok": true, "device": {...}}.
Without a CUDA device it exits 1. The kernels (nvcc, kwage_tpu_torch/csrc)
and the host library (g++, kwage_tpu_torch/native) build into
build/kwage_tpu_torch/. Nothing of kwage_tpu or jax is imported: the host
references are the port's own host engines and tests/golden.

The at-scale proofs and the parity soak are programs of their own, run
alone (``kwage_tpu_torch.scale``; each keeps its JAX tool's env knobs):
``python3 -m kwage_tpu_torch.scale.at_scale`` (L=18, SCALE_N_ACC 4350,
SCALE_HALT 4200, SCALE_DEVICE_N 1024), ``... scale.prod_l`` (SCALE_L 26,
SCALE_N_ACC 2268, one full 16 GiB file; ``--device-only WORKDIR``) and
``... scale.soak ROUNDS SEED_BASE``; with ``KWAGE_TORCH_DEVICE=cpu`` and
small knobs they run on the CPU, as tests/test_torch_scale.py runs them.

``--profile`` runs phases 6, 11 and 8 alone, with their checks, and breaks
down the kwage-maestro-torch calls (phase 11: the coordinator's process)
and each kwage-sriracha-torch --device call: host-clock time per step (each step function of the port's
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
import dataclasses
import functools
import hashlib
import io
import json
import os
import re
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kwage_tpu_torch import kernels
from kwage_tpu_torch.cli import sriracha as torch_sriracha_cli
from kwage_tpu_torch.cli.kwage import main as torch_kwage_main
from kwage_tpu_torch.cli.maestro import LISTENING
from kwage_tpu_torch.cli.maestro import main as torch_maestro_main
from kwage_tpu_torch.cli.sriracha import main as torch_sriracha_main
from kwage_tpu_torch.core import FilterInfo, accession_to_str, str_to_accession
from kwage_tpu_torch.core.params import BloomParam
from kwage_tpu_torch.bench import search_phases
from kwage_tpu_torch.bench._common import card_identity, exact_bloom
from kwage_tpu_torch.bench.sriracha import counts_work, read_block, reads_work
from kwage_tpu_torch.bench.search_routes import (
    H2D_BYTES,
    batch_for_share,
    canon,
    gather_share,
    h2d_rates,
)
from kwage_tpu_torch.core.words import canonical_kmers
from kwage_tpu_torch.entry import dryrun_multichip, entry
from kwage_tpu_torch.io.binary import BinaryReader, BinaryWriter
from kwage_tpu_torch.io.bloom_file import BloomFilterRecord, read_bloom_file, write_bloom_file
from kwage_tpu_torch.io.db_file import HEADER_SIZE, DBFileHeader
from kwage_tpu_torch.io.dbz_file import open_database
from kwage_tpu_torch.io.inventory import write_inventory
from kwage_tpu_torch.io.status import read_status_file
from kwage_tpu_torch.kernels.time_kernel import (
    HBM_BYTES_PER_S,
    INT32_OPS_PER_S,
    fused_batch_pairs,
    murmur_ops,
    sort_case,
    sriracha_routes,
)
from kwage_tpu_torch.native import available as native_available
from kwage_tpu_torch.native import canonical_kmers_native, murmur32_native
from kwage_tpu_torch.ops import counting as tcount
from kwage_tpu_torch.ops import hashing as th
from kwage_tpu_torch.ops import kmers as tk
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.ops import transpose as tt
from kwage_tpu_torch.parallel import maestro as torch_maestro
from kwage_tpu_torch.parallel import mesh as tmesh
from kwage_tpu_torch.parallel.mesh import make_search_mesh
from kwage_tpu_torch.parallel import sharded_search as tsh
from kwage_tpu_torch.parallel.sharded_search import ShardedDatabase
from kwage_tpu_torch.parallel.maestro import (
    STATUS_DATABASE_SUCCESS,
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
)
from kwage_tpu_torch.pipeline import build_db as torch_build_db
from kwage_tpu_torch.pipeline import make_bloom as torch_make_bloom
from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files
from kwage_tpu_torch.pipeline.make_bloom import BuildOptions, build_bloom_from_file
from kwage_tpu_torch.scale import _corpus as scale_corpus
from kwage_tpu_torch.search.engine import search_database_files
from kwage_tpu_torch.search.resident import MeshResidentSearcher, ResidentSearcher, SearchServer
from kwage_tpu_torch.search.resident import render as render_searcher
from kwage_tpu_torch.sriracha import device as tsr
from kwage_tpu_torch.sriracha.engine import (
    SrirachaOptions,
    StreamStats,
    format_results,
    iter_reads_range,
    load_subject_kmers,
)
from kwage_tpu_torch.utils.runtime import resolve_device

NUM_FILTER = 2048          # the reference's quota file (options.h:137-157)
LOG2_FILTER_LEN = 22
KMER_LEN = 31
NUM_HASH = 5
COPIES = 8                 # fused .db copies in phases 2-3 (bench.py:42-47)
MESH_SHARDS = 4            # phase 9: logical shards a card
MESH_WAVE_BUDGET = 1 << 30  # phase 9, streamed runs: bytes a shard (8 GiB: 4 waves of 2 GiB)
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
# Phase 8's long reads: an ONT run's ~1.2 kbp ARTIC amplicons of the
# subjects (SARS-CoV-2-sized genomes) and genomic ONT or PacBio reads
# log-uniform in 1-16 kbp, with reads on the buckets' edges: every read in
# a bucket of 1024-16384 bases (the sriracha_block route).
# Reads on both sides of 2^14 windows at k = 11 and 21 (16384 + k - 1 and
# 16384 + k bp) and of 16385 bp: the 32768 bucket's rows that the block
# kernel sorts from canonical words, and its first rows of the tile chain.
SR_EDGE_BP = [16385, 16394, 16395, 16404, 16405]
LR_READS = 8192
LR_AMPLICON_BP, LR_AMPLICON_SPREAD = 1200, 100
LR_GENOMIC_BP = (1000, 16000)
LR_EDGES = [1024, 1025, 2048, 2049, 4096, 4097, 8192, 8193, 16384]
LR_RUNS = [("C", 21, 0.8), ("D", 11, 0.8)]   # (run, k, threshold): the hash, the LUT
# The host engine that phase 8's runs are held to runs in the machine's
# cores (up to 8): in one thread it took 15.9-20.2 s a short-read run and
# 19.6-20.5 s a long-read run (1.4 Mbp/s) on the card's host (NVIDIA H100
# 80GB HBM3 at 700 W), most of phase 8's wall.
HOST_THREADS = min(8, os.cpu_count() or 1)
READ_MESH_SLOTS = 4        # phase 10: logical slots of the card for SriRachA's reads
REMOTE_BATCH = 4           # phase 11: accessions a device worker pulls at once
CHUNK_BP = 8_000_000       # phase 12: the JAX package's chunk_bp (a 16 GB TPU's)
CROWDED_FREE = 3 << 30     # phase 12: device bytes left free for the builds in threads
# Phase 12's two-process step: the device bytes left free for each round,
# narrowed round by round until a child's halving retry fires. On an NVIDIA
# H100 80GB HBM3 at 700 W it never fired at 3, 2 or 1 GiB free and fired
# in 4 of 5 rounds at 768 MiB (run_two_process_builds and two smokes); at
# 512 MiB the 4 builds in threads of one process ran out of memory at one
# row (their accumulators take the rest), so 768 MiB is the last level,
# tried up to five times.
TWO_PROCESS_FREE = (CROWDED_FREE, 2 << 30, 1 << 30) + (768 << 20,) * 5
# Phase 14, the production-L path: the prodL corpus's first 64 accessions
# (30 kbp genomes at 4x, 160 bp reads, min count 2) built at L pinned to 26
# (8 MiB filters), each .bloom listed 32 times to pack one full quota file
# (2048 filters, 16 GiB, twice the default fusion budget).
PROD_L = 26
PROD_ACC = 64
PROD_COPIES = 32
PROD_GENOME = 30_000
PROD_MIN_COUNT = 2
PROD_RANDOM_QUERIES = 8
PROD_CASES = [(1.0, "json"), (0.8, "csv")]
PROD_RESIDENT_BUDGET = 17 << 30   # both files resident
PROD_MESH_BUDGET = 2 << 30        # a logical shard's: the full file in waves
# Phase 13: the bench programs (module, arguments, environment, seconds
# allowed). Search at bench.py's full width (2^22 rows x 8 files, 8 GiB),
# build and SriRachA at their JAX programs' defaults and SriRachA at k=11
# on the LUT; serve cut from tools/bench_resident.py's 4350 accessions to
# 1000 for the smoke's time (it runs whole apart: README).
BENCH_RUNS = [
    ("search", [], {}, 300),
    ("build", [], {}, 300),
    ("sriracha", [], {}, 300),
    ("sriracha", ["11", "128", "65536", "lut"], {}, 300),
    ("serve", [], {"SCALE_N_ACC": "1000"}, 400),
]
# Phase 15: the JAX package's last programs (module, environment, seconds
# allowed), each at its JAX tool's defaults; the distributed proof without
# its latency regime (SCALE_SKIP_LATENCY=1) and at 250 of its 1000
# accessions, for the smoke's time (it runs whole apart: README).
TOOL_RUNS = [
    ("bench.search_phases", {}, 300),
    ("bench.sorted_gather", {}, 200),
    ("bench.ingest", {}, 200),
    ("bench.build_phases", {}, 200),
    ("bench.sriracha_model", {}, 200),
    ("bench.scaling", {}, 300),
    ("scale.distributed", {"SCALE_SKIP_LATENCY": "1", "SCALE_N_ACC": "250"}, 600),
]
# The dry scheduler runs before phase 1, on a disk nothing has written to
# yet: its 28 checkpoints are fsynced, and an fsync waits on what the disk
# still has to write. After phase 14's 17 GB .db it took 22.7-31.6 s and
# once ran past 300 s; alone, 17.7-22.7 s.
SCHEDULER_RUNS = [("scale.dry_sched", {}, 300)]
# The smoke's limit, seconds from the start of main (the command's limit is
# 1200 s): a phase-15 program is cut this long before it, with its output
# printed, so that what follows it still runs and the cause is seen.
SMOKE_SECONDS = 1200
SMOKE_RESERVE = 60
# The measurement-only kernels of phase 15 (csrc/variants/search_phases.cu):
# they replace no TPU kernel; "replaces" names the JAX tool's phase function
# each stands for.
VARIANT_SOURCE = "kwage_tpu_torch/csrc/variants/search_phases.cu"
VARIANT_OF = {"gather1": "tools/bench_search_phases.py:104",
              "gather5_and": "tools/bench_search_phases.py:109"}
# Paths (each driven with the launch counts zeroed just before it) and
# the kernels each must launch.
PATH_KERNELS = {
    "search": ("bit_transpose", "search_complete", "search_counts"),
    "mesh": ("search_complete", "search_counts", "search_total_hits", "canonical_kmers",
             "radix_sort_pairs", "select_runs", "bloom_set_bits", "bit_transpose"),
    "ingest": ("canonical_kmers", "radix_sort_pairs", "select_runs", "bloom_set_bits",
               "bit_transpose", "search_complete", "search_counts", "run_counts"),
    "entry": ("canonical_kmers", "murmur32", "search_counts"),
    "sriracha": ("canonical_kmers", "sriracha_counts_lut", "sriracha_counts_hash",
                 "sriracha_reads_lut", "sriracha_reads_hash", "sriracha_block_lut",
                 "sriracha_block_hash", "subject_table"),
    "sriracha_mesh": ("canonical_kmers", "sriracha_counts_lut", "sriracha_counts_hash",
                      "sriracha_reads_lut", "sriracha_reads_hash", "subject_table"),
    "remote": ("canonical_kmers", "radix_sort_pairs", "select_runs", "bloom_set_bits",
               "bit_transpose", "run_counts"),
    "chunked": ("canonical_kmers", "radix_sort_pairs", "run_counts", "merge_counts",
                "bloom_set_bits"),
    "prod_l": ("canonical_kmers", "radix_sort_pairs", "select_runs", "bloom_set_bits",
               "bit_transpose", "search_complete", "search_counts", "search_total_hits"),
    "tools": ("search_complete", "search_counts", "canonical_kmers", "radix_sort_pairs",
              "select_runs", "bloom_set_bits", "sriracha_reads_hash", "bit_transpose",
              "gather1", "gather5_and"),
}
# The TPU kernel each CUDA kernel replaces.
REPLACES = {
    "bit_transpose": "kwage_tpu/ops/transpose.py:101",
    "search_complete": "kwage_tpu/ops/search.py:88",
    "search_counts": "kwage_tpu/ops/search.py:136",
    "search_total_hits": "kwage_tpu/parallel/sharded_search.py:61",
    "canonical_kmers": "kwage_tpu/ops/kmers.py:67",
    "murmur32": "kwage_tpu/ops/hashing.py:59",
    "radix_sort_pairs": "kwage_tpu/ops/counting.py:46",
    "select_runs": "kwage_tpu/ops/counting.py:206",
    "bloom_set_bits": "tools/exp_pallas_bitset.py:76",
    "sriracha_counts_lut": "kwage_tpu/sriracha/device.py:239",
    "sriracha_counts_hash": "kwage_tpu/sriracha/device.py:179",
    "sriracha_reads_lut": "kwage_tpu/sriracha/device.py:239",
    "sriracha_reads_hash": "kwage_tpu/sriracha/device.py:179",
    "sriracha_block_lut": "kwage_tpu/sriracha/device.py:239",
    "sriracha_block_hash": "kwage_tpu/sriracha/device.py:179",
    "subject_table": "kwage_tpu/sriracha/device.py:216",
    "run_counts": "kwage_tpu/pipeline/make_bloom.py:222",
    "merge_counts": "kwage_tpu/pipeline/make_bloom.py:156",
}
SOURCES = {
    "bit_transpose": "kwage_tpu_torch/csrc/bit_transpose.cu",
    "search_complete": "kwage_tpu_torch/csrc/search.cu",
    "search_counts": "kwage_tpu_torch/csrc/search.cu",
    "search_total_hits": "kwage_tpu_torch/csrc/search.cu",
    "canonical_kmers": "kwage_tpu_torch/csrc/kmers.cu",
    "murmur32": "kwage_tpu_torch/csrc/murmur.cu",
    "radix_sort_pairs": "kwage_tpu_torch/csrc/sort.cu",
    "select_runs": "kwage_tpu_torch/csrc/counting.cu",
    "bloom_set_bits": "kwage_tpu_torch/csrc/bitset.cu",
    "sriracha_counts_lut": "kwage_tpu_torch/csrc/sriracha.cu",
    "sriracha_counts_hash": "kwage_tpu_torch/csrc/sriracha.cu",
    "sriracha_reads_lut": "kwage_tpu_torch/csrc/sriracha.cu",
    "sriracha_reads_hash": "kwage_tpu_torch/csrc/sriracha.cu",
    "sriracha_block_lut": "kwage_tpu_torch/csrc/sriracha_block_lut.cu",
    "sriracha_block_hash": "kwage_tpu_torch/csrc/sriracha_block_hash.cu",
    "subject_table": "kwage_tpu_torch/csrc/sriracha.cu",
    "run_counts": "kwage_tpu_torch/csrc/merge.cu",
    "merge_counts": "kwage_tpu_torch/csrc/merge.cu",
}
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

@contextlib.contextmanager
def search_steps(steps: dict):
    """Inside, every ``search_files_device`` call (the kwage CLI's --device
    path on one card) adds its step times to ``steps``."""
    real = ts.search_files_device

    def profiled(*args, **kwargs):
        return real(*args, **{**kwargs, "profile": steps})

    ts.search_files_device = profiled
    try:
        yield steps
    finally:
        ts.search_files_device = real


@contextlib.contextmanager
def mesh_steps(steps: dict):
    """Inside, every ``search_sharded_groups`` call (a MeshResidentSearcher's
    search, the one-shot ``sharded_search_files`` of kwage --device on
    several cards) adds its step times to ``steps``."""
    real = tsh.search_sharded_groups

    def profiled(groups, db_paths, queries, threshold, profile=None):
        return real(groups, db_paths, queries, threshold, profile=steps)

    tsh.search_sharded_groups = profiled
    try:
        yield steps
    finally:
        tsh.search_sharded_groups = real


@contextlib.contextmanager
def counted_gathers():
    """Inside, every chunk of gathered rows that ``ops.search.eval_chunk_cols``
    uploads (a ``HostChunk`` with ``rows``) appends its (rows, words) to
    the list yielded."""
    real, shapes = ts.eval_chunk_cols, []

    def counting(words, *args, **kwargs):
        if isinstance(words, ts.HostChunk) and words.rows is not None:
            shapes.append(words.shape)
        return real(words, *args, **kwargs)

    ts.eval_chunk_cols = counting
    try:
        yield shapes
    finally:
        ts.eval_chunk_cols = real


def fmt_steps(steps: dict) -> str:
    """A device search call's profile on one line."""
    parts = []
    for k, v in steps.items():
        if isinstance(v, dict):
            parts.append(f"{k} " + "/".join(f"{a} {n}" for a, n in v.items()))
        elif isinstance(v, float):
            parts.append(f"{k} {v:.4f} s")
        else:
            parts.append(f"{k} {v}")
    return ", ".join(parts)


RULE_SHARE = 0.7           # phase 2's rule step: rows touched, past GATHER_SHARE
RULE_SLABS = 8             # ... under a budget of an eighth of a file


def run_rule_step(files: list[str], planted: list[str], device: torch.device, n_filter: int,
                  log2_len: int) -> str:
    """Phase 2's check of ``search_chunk``'s rule on the card: random 400 bp
    queries touching RULE_SHARE of the rows of two of phase 2's files, and
    the ``planted`` ones (so that hit lists are not empty), under a budget
    of 1/RULE_SLABS of a file, so that each file is its own chunk and
    streams in slabs by either route. On the card the rows are
    under GATHER_SHARE for each of the full route's slabs, but past it once
    the gathered rows' own slabs are counted: the call must take the full
    route (``profile["route"]``), its hit lists == the gather route's
    (GATHER_SHARE set to 1). Returns the step's report."""
    files = files[:2]
    budget = os.path.getsize(files[0]) // RULE_SLABS
    queries, _ = batch_for_share(RULE_SHARE, log2_len, 0)
    queries += [(len(queries) + i, q) for i, q in enumerate(planted)]
    idx, _, _ = ts.make_query_batch([q for _, q in queries], KMER_LEN, NUM_HASH, log2_len)
    rows = len(np.unique(idx))
    L = 1 << log2_len
    W = -(-n_filter // 32)
    result_word_bytes = 4 * len(queries)          # threshold 1.0: a mask word a query
    passes = -(-W // ts._slab_words(L, W, budget, result_word_bytes))
    gathered = -(-W // ts._slab_words(rows, W, budget, result_word_bytes))
    if device.type == "cuda":
        check(rows <= ts.GATHER_SHARE * L * passes < rows * gathered,
              f"the rule step's batch ({rows} rows, {passes} / {gathered} slabs) does not "
              f"separate the rule from one that counts only the full route's slabs")
    got, walls = {}, {}
    old = os.environ.get("KWAGE_FUSION_BUDGET_BYTES")
    os.environ["KWAGE_FUSION_BUDGET_BYTES"] = str(budget)
    try:
        for name, share in (("rule", None), ("gather", 1.0)):
            steps: dict = {}
            t0 = time.perf_counter()
            with gather_share(share):
                got[name] = canon(ts.search_files_device(files, queries, 1.0, device,
                                                         profile=steps))
            walls[name] = (time.perf_counter() - t0, steps)
    finally:
        if old is None:
            del os.environ["KWAGE_FUSION_BUDGET_BYTES"]
        else:
            os.environ["KWAGE_FUSION_BUDGET_BYTES"] = old
    check(walls["rule"][1]["route"] == {"gather": 0, "full": len(files)},
          f"the rule step took another route than the full one: {walls['rule'][1]}")
    check(walls["gather"][1]["route"] == {"gather": len(files), "full": 0},
          f"the rule step's forced gather took another route: {walls['gather'][1]}")
    check(got["rule"] == got["gather"] and bool(got["rule"]),
          "the rule step's hit lists differ between routes, or are empty")
    return (f"the rule at {budget} B a chunk, {len(queries)} queries touching {rows} rows "
            f"({rows / L:.3f} of L), {passes} slabs a file by the full route, {gathered} "
            f"by the gather: " + "; ".join(f"{n} {w:.4f} s ({fmt_steps(st)})"
                                           for n, (w, st) in walls.items())
            + f", {sum(map(len, got['rule'].values()))} hits by both")


def run_main_path(work: str, device: torch.device, n_filter: int, log2_len: int,
                  copies: int, seed: int) -> dict:
    """Phases 1-3 through the port's entry points; returns phase 2's
    outputs keyed by case, the fused files and the query sequences (phase
    9 searches them again). Runs on any torch device (on the CPU with the
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
    outputs, times, calls = {}, [], []
    # (name, GATHER_SHARE or None for the host engine, kwage's extra flags)
    runs = (("gather", ts.GATHER_SHARE, ["--device"]), ("full", 0.0, ["--device"]),
            ("host", None, []))
    for threshold, fmt in CASES:
        got = {}
        for name, share, extra in runs:
            out = os.path.join(work, f"{name}.out")
            steps: dict = {}
            t0 = time.perf_counter()
            with (search_steps(steps) if share is not None else contextlib.nullcontext()), \
                    gather_share(share):
                rc = torch_kwage_main(base + ["-t", str(threshold), f"--o.{fmt}", "-o", out]
                                      + extra + seqs)
            times.append(f"{name} t={threshold} {fmt} {time.perf_counter() - t0:.2f} s")
            check(rc == 0, f"{name} kwage exited {rc}")
            if share is not None:
                check(steps["route"][name] == 1 and sum(steps["route"].values()) == 1,
                      f"the {name} call took another route: {steps}")
                calls.append(f"{name} t={threshold} {fmt}: {fmt_steps(steps)}")
            with open(out) as f:
                got[name] = f.read()
        for name in ("gather", "full"):
            check(got[name] == got["host"], f"--device output by the {name} route differs "
                                            f"from the host engine at -t {threshold} {fmt}")
        if fmt == "csv":
            check(csv_hits(got["host"]) == expected_hits(queries, holders, threshold, copies),
                  f"hits at -t {threshold} are not exactly the planted ones")
        outputs[(threshold, fmt)] = got["host"]
    n_hits = sum(expected_hits(queries, holders, 0.5, copies).values())
    one_call = []
    for name, share, _ in runs[:2]:
        steps = {}
        t0 = time.perf_counter()
        with gather_share(share):
            ts.search_files_device(files, list(enumerate(seqs)), 0.5, device, profile=steps)
        one_call.append(f"{name} {time.perf_counter() - t0:.4f} s ({fmt_steps(steps)})")
    rule = run_rule_step(files, seqs, device, n_filter, log2_len)
    rates = h2d_rates(device)
    print(f"phase 2 search: {len(queries)} queries x {copies} fused files "
          f"(W={copies * ((n_filter + 31) // 32)}), bytes == host engine by both routes, "
          f"{n_hits} planted hits at -t 0.5; {'; '.join(times)}; the device calls: "
          f"{'; '.join(calls)}; one device search call at -t 0.5 by each route: "
          f"{'; '.join(one_call)}; {rule}; host-to-device "
          + (", ".join(f"{k} {v:.3f}" for k, v in rates.items()) if rates else "not measured")
          + f" ({H2D_BYTES} B copies)", flush=True)

    # Phase 3: the resident server answers the same requests.
    t0 = time.perf_counter()
    server = SearchServer(files, host="127.0.0.1", port=0, engine="device", device=device)
    t_load = time.perf_counter() - t0
    server.start()
    try:
        lat = []
        with socket.create_connection(server.address, timeout=600) as sock, \
                sock.makefile("rw", encoding="utf-8") as f:
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
    # The server's streamed groups: half the corpus's bytes keeps some files
    # resident and streams the rest per request, by each route.
    total = sum(os.path.getsize(f) for f in files)
    t0 = time.perf_counter()
    streamed = ResidentSearcher(files, device, budget_bytes=total // 2)
    t_part = time.perf_counter() - t0
    hosted = sum(1 for _, db, _ in streamed._groups if isinstance(db, ts.HostChunk))
    check(hosted > 0, "the half-budget searcher streams no group")
    part_lat = []
    for name, share, _ in runs[:2]:
        with gather_share(share), counted_gathers() as gathered:
            for threshold, fmt in CASES:
                t0 = time.perf_counter()
                out = streamed.render(seqs, threshold, fmt)
                part_lat.append(f"{name} {(time.perf_counter() - t0) * 1e3:.1f} ms")
                check(out == outputs[(threshold, fmt)], f"the half-budget searcher by the "
                                                        f"{name} route differs at -t {threshold} {fmt}")
        check(len(gathered) == (hosted * len(CASES) if name == "gather" else 0),
              f"{name} route: {len(gathered)} gathers for {hosted} streamed groups")
    print(f"phase 3 serve: {resident} B resident, load {t_load:.2f} s, "
          f"{len(CASES)} requests == phase 2 bytes, latency "
          + ", ".join(f"{x * 1e3:.1f} ms" for x in lat)
          + f"; a ResidentSearcher at {total // 2} B: {streamed.resident_bytes} B resident, "
          f"{hosted} groups streamed, load {t_part:.2f} s, renders == phase 2 bytes by both "
          f"routes: " + ", ".join(part_lat), flush=True)
    del streamed
    return {"outputs": outputs, "files": files, "seqs": seqs}


# --- phase 9: the sharded search ------------------------------------------------------

class OneStreamSearcher:
    """MeshResidentSearcher's contract over ONE ShardedDatabase.from_files
    of all the files: under a budget, a single stream of column waves."""

    def __init__(self, db_paths, mesh, budget_bytes=None):
        self.db_paths = db_paths
        self.groups = [(ShardedDatabase.from_files(mesh, db_paths, budget_bytes),
                        list(range(len(db_paths))))]

    def search(self, queries, threshold):
        return tsh.search_sharded_groups(self.groups, self.db_paths, queries, threshold)

    def render(self, queries, threshold, fmt):
        return render_searcher(self, queries, threshold, fmt)


def run_mesh(main: dict, device: torch.device, shards: int = MESH_SHARDS,
             wave_budget: int = MESH_WAVE_BUDGET, dryrun_devices: int = 4) -> None:
    """Phase 9 over phase 1-3's files (``main``: run_main_path's result):
    the mesh searchers on ``shards`` logical shards of ``device`` (on
    every card where several are visible), each against phase 2's bytes
    (the streamed ones by the gather and the full route), the totals
    against the hit lists, the streamed runs' peak device memory against
    their budget; kwage --device with the slots listed as cards (the CLI's
    several-card branch, by both routes); then dryrun_multichip."""
    files, seqs, outputs = main["files"], main["seqs"], main["outputs"]
    cuda = device.type == "cuda"
    cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if cuda else [device])
    devices = [cards[i * len(cards) // shards] for i in range(shards)]
    on_a_card = max(devices.count(d) for d in cards)
    hits = {t: collections.Counter(
        r[0] for r in list(csv.reader(io.StringIO(outputs[(t, "csv")])))[1:])
        for t in (1.0, 0.5)}

    def totals_equal_hit_lists(sdbs, tag, steps):
        for t in (1.0, 0.5):
            got = sum(sdb.total_hits(seqs, t, steps) for sdb in sdbs)
            want = [hits[t][f"command line seq {i}"] for i in range(len(seqs))]
            check(got.tolist() == want, f"{tag}: total_hits at -t {t} {got.tolist()} != the "
                                        f"hit-list lengths {want}")
        check(sum(hits[0.5].values()) > 0, "no hits to count")

    report = []
    # (tag, mesh shape, budget a shard, how the searcher is made). Under
    # the budget MeshResidentSearcher keeps the first file chunk resident
    # (half the budget) and streams the others, two waves of a quarter of
    # the budget a shard each; from_files streams
    # all 8 files as one group, four waves of half the budget a shard, so
    # the third wave reuses the first one's buffer.
    runs = [("1 x %d resident" % shards, (1, shards), None, MeshResidentSearcher),
            ("2 x %d resident" % (shards // 2), (2, shards // 2), None, MeshResidentSearcher),
            ("1 x %d part resident" % shards, (1, shards), wave_budget, MeshResidentSearcher),
            ("1 x %d one stream" % shards, (1, shards), wave_budget, OneStreamSearcher)]
    for tag, shape, budget, make in runs:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated(device) if cuda else 0
        mesh = make_search_mesh(*shape, devices)
        t0 = time.perf_counter()
        searcher = make(files, mesh, budget_bytes=budget)
        t_load = time.perf_counter() - t0
        sdbs = [sdb for sdb, _ in searcher.groups]
        # The most waves of one stream: from the third on, a wave is staged
        # into a buffer that an earlier wave has left.
        waves = max(sdb.num_waves for sdb in sdbs)
        if budget is None:
            check(all(sdb.db is not None for sdb in sdbs) and waves == 1, f"{tag}: residency")
        else:
            check(any(sdb.db is None for sdb in sdbs), f"{tag}: nothing streams")
            check((make is OneStreamSearcher) != any(sdb.db is not None for sdb in sdbs),
                  f"{tag}: residency {[sdb.db is not None for sdb in sdbs]}")
            check(waves >= (3 if make is OneStreamSearcher else 2),
                  f"{tag}: at most {waves} waves a stream")
        times, calls = [], []
        streamed = sum(sdb.db is None for sdb in sdbs)
        # A streamed searcher renders and counts by both routes (the
        # resident groups stay as they are); a resident one has no route
        # to choose.
        routes = (("gather", ts.GATHER_SHARE), ("full", 0.0)) if streamed else (("", None),)
        for name, share in routes:
            steps: dict = {}
            with gather_share(share), mesh_steps(steps):
                for threshold, fmt in CASES:
                    t0 = time.perf_counter()
                    out = searcher.render(seqs, threshold, fmt)
                    times.append(f"{name} {time.perf_counter() - t0:.3f} s".strip())
                    check(out == outputs[(threshold, fmt)],
                          f"{tag}: bytes differ from phase 2's by the {name or 'resident'} "
                          f"route at -t {threshold} {fmt}")
            counted: dict = {}
            if shape[0] == 1:
                t0 = time.perf_counter()
                with gather_share(share):
                    totals_equal_hit_lists(sdbs, tag, counted)
                t_count = time.perf_counter() - t0
            if streamed:
                for what, got, n in (("renders", steps, len(CASES)), ("counts", counted, 2)):
                    if not got:
                        continue
                    want = {"gather": 0, "full": 0, "resident": (len(sdbs) - streamed) * n}
                    want[name] = streamed * n
                    check({"resident": 0, **got["route"]} == want,
                          f"{tag}: the {name} {what} took other routes: {got['route']}")
                calls.append(f"{name}: {fmt_steps(steps)}"
                             + (f"; total_hits at -t 1.0 and 0.5 {t_count:.3f} s "
                                f"({fmt_steps(counted)})" if counted else ""))
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if budget is not None and cuda:
            # Two buffers a shard and the query batch, outputs and staging
            # of a search call (64 MiB allowed for those).
            check(peak <= budget * on_a_card + (64 << 20),
                  f"{tag}: peak {peak} B passes {on_a_card} x {budget} B")
        report.append(f"{tag}: load {t_load:.2f} s, waves a group "
                      + ", ".join("resident" if sdb.db is not None else
                                  f"{sdb.num_waves} of {sdb.wave_shard_bytes} B a shard"
                                  for sdb in sdbs) + ", searches " + ", ".join(times)
                      + (f" (the {len(CASES)} renders' steps by route: " + "; ".join(calls)
                         + ")" if calls else "")
                      + f", peak device memory {peak} B"
                      + (f" of {on_a_card} x {budget} B" if budget is not None else ""))
        del searcher, sdbs
        if cuda:
            # Dropped, the searcher frees its device memory at once: nothing
            # of it may wait in a reference cycle for the collector.
            torch.cuda.synchronize()
            left = torch.cuda.memory_allocated(device)
            check(left == base, f"{tag}: {left} B allocated after del, {base} B before the run")
    report.append(run_mesh_cli(main, device, devices, on_a_card))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        dryrun_multichip(dryrun_devices)
    t_dry = time.perf_counter() - t0
    print(f"phase 9 mesh: {len(files)} files on {shards} logical shard(s) over {len(cards)} "
          f"card(s), bytes == phase 2's on every mesh, total_hits == the hit-list lengths at "
          f"-t 1.0 and 0.5; " + "; ".join(report)
          + f"; dryrun_multichip({dryrun_devices}) {t_dry:.2f} s ("
          + said.getvalue().strip().replace("\n", " | ") + ")", flush=True)


def run_mesh_cli(main: dict, device: torch.device, devices: list, on_a_card: int) -> str:
    """kwage --device over phase 2's files with ``parallel.mesh.
    default_devices`` listing ``devices`` (the card as several): the CLI's
    several-card branch, the one-shot ``sharded_search_files``. Every case
    by the gather route, one by the full route, each == phase 2's bytes,
    peak device memory within the budget a shard x the shards a card
    holds; returns phase 9's report of it."""
    files, seqs, outputs = main["files"], main["seqs"], main["outputs"]
    cuda = device.type == "cuda"
    base = [a for f in files for a in ("-d", f)]
    out = os.path.join(os.path.dirname(files[0]), "mesh_cli.out")
    budget = ts.fusion_budget_bytes()
    saved = tmesh.default_devices
    tmesh.default_devices = lambda: list(devices)
    calls = []
    try:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for name, share, cases in (("gather", ts.GATHER_SHARE, CASES), ("full", 0.0, CASES[-1:])):
            for threshold, fmt in cases:
                steps: dict = {}
                t0 = time.perf_counter()
                with gather_share(share), mesh_steps(steps):
                    rc = torch_kwage_main(base + ["-t", str(threshold), f"--o.{fmt}", "-o", out,
                                                  "--device"] + seqs)
                wall = time.perf_counter() - t0
                check(rc == 0, f"kwage --device on {len(devices)} slots exited {rc}")
                with open(out) as f:
                    check(f.read() == outputs[(threshold, fmt)],
                          f"kwage --device on {len(devices)} slots by the {name} route differs "
                          f"from phase 2's bytes at -t {threshold} {fmt}")
                check(steps["route"][name] >= 1 and sum(steps["route"].values())
                      == steps["route"][name], f"the {name} CLI call took another route: {steps}")
                calls.append(f"{name} t={threshold} {fmt} {wall:.3f} s ({fmt_steps(steps)})")
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        check(peak <= budget * on_a_card + (64 << 20),
              f"kwage --device on {len(devices)} slots: peak {peak} B passes {on_a_card} x "
              f"{budget} B")
    finally:
        tmesh.default_devices = saved
    return (f"kwage --device with {len(devices)} slots listed as cards (the one-shot mesh "
            f"search) == phase 2's bytes: " + "; ".join(calls)
            + f", peak device memory {peak} B of {on_a_card} x {budget} B")


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
                        "complete_device_batch", "build_bloom_device", "_pack_file_block",
                        "_pack_strings", "count_chunk", "merge_counts",
                        "count_kmers_multi_packed", "bloom_set_bits", "set_filter_bits",
                        "filter_words_to_bytes")),
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


# Library calls that compact a CUDA tensor (or count its runs): refused
# inside the functions of WATCHED, where the kernels do that work themselves.
COMPACTING = ((torch, "nonzero"), (torch.Tensor, "nonzero"), (torch, "argwhere"),
              (torch.Tensor, "argwhere"), (torch, "masked_select"),
              (torch.Tensor, "masked_select"), (torch, "unique"), (torch.Tensor, "unique"),
              (torch, "unique_consecutive"), (torch.Tensor, "unique_consecutive"))
SORTING = ((torch, "sort"), (torch, "argsort"), (torch.Tensor, "sort"), (torch.Tensor, "argsort"))
# (module, function, the guard's count of its calls)
WATCHED = ((tcount, "sort_valid_windows", "sorts"), (torch_make_bloom, "build_bloom_device",
                                                      "builds"))
_INSIDE = threading.local()   # .depth: WATCHED calls this thread is inside


def _is_mask(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items)


@contextlib.contextmanager
def _refused(targets, active):
    """Inside, each (owner, name) of ``targets`` raises when it is called on
    a CUDA tensor (``__getitem__``: when indexed by a boolean mask) while
    ``active()`` holds in the calling thread; the originals come back on
    exit."""
    saved = {(owner, name): getattr(owner, name) for owner, name in targets}

    def refusing(fn, name):
        @functools.wraps(fn)
        def wrapper(t, *args, **kwargs):
            if isinstance(t, torch.Tensor) and t.is_cuda and active() and (
                    name != "__getitem__" or _is_mask(args[0])):
                raise RuntimeError(f"{name} of a CUDA tensor on the device path")
            return fn(t, *args, **kwargs)
        return wrapper

    for (owner, name), fn in saved.items():
        setattr(owner, name, refusing(fn, name))
    try:
        yield
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)


@contextlib.contextmanager
def no_library_sort():
    """Inside, in every thread, torch.sort, Tensor.sort and argsort of a
    CUDA tensor raise; and while a thread runs a function of WATCHED
    (``sort_valid_windows``, ``build_bloom_device``), so do torch.nonzero,
    argwhere, masked_select, unique, unique_consecutive and indexing by a
    boolean mask in that thread. The wrappers are installed once for the
    whole block and read a thread-local depth, so threads that run these
    functions at once (the coordinator's workers) cannot undo each other's
    refusal. Yields a dict that counts the WATCHED calls by kind."""
    watch = {key: 0 for _, _, key in WATCHED}
    lock = threading.Lock()

    def watched(fn, key):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with lock:
                watch[key] += 1
            _INSIDE.depth = getattr(_INSIDE, "depth", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                _INSIDE.depth -= 1
        return wrapper

    saved = [(module, name, getattr(module, name)) for module, name, _ in WATCHED]
    for (module, name, fn), (_, _, key) in zip(saved, WATCHED):
        setattr(module, name, watched(fn, key))
    try:
        with _refused(SORTING, lambda: True), \
                _refused((*COMPACTING, (torch.Tensor, "__getitem__")),
                         lambda: getattr(_INSIDE, "depth", 0) > 0):
            yield watch
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def print_profile(call: str, wall: float, report: dict) -> None:
    print(f"profile: {call} {wall:.3f} s under the step timers and the profiler; device "
          f"busy (kernel, copy and memset self time) {report['busy_s']:.4f} s, idle share "
          f"{1 - report['busy_s'] / wall:.4f}")
    for name, secs, calls in report["steps"]:
        print(f"profile step {name:<40} {secs:8.3f} s  x{calls}")
    print(report["table"], flush=True)


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
            truth[acc] = exact_bloom(reads, INGEST_K, MIN_COUNT)
            del reads
    t_data = time.perf_counter() - t0
    write_inventory(os.path.join(work, "inv.bin"),
                    [FilterInfo(run_accession=str_to_accession(a)) for a in accs])

    with (step_profile(device, INGEST_STEPS) if profile else contextlib.nullcontext()) as report, \
            no_library_sort() as guard:
        t0 = time.perf_counter()
        rc = torch_maestro_main([
            "--meta", os.path.join(work, "inv.bin"), "--scratch", work,
            "--status", os.path.join(work, "status.bin"), "--source-dir", src,
            "-k", str(INGEST_K), "--min-kmer-count", str(MIN_COUNT), "--device-build",
            "--device-transpose", "--device-batch", "16", "--workers", "2", "--save.bloom"])
        t_dev = time.perf_counter() - t0
    check(rc == 0, f"kwage-maestro-torch exited {rc}")
    check(guard["sorts"] > 0 and guard["builds"] > 0,
          f"no sort_valid_windows or build_bloom_device call ran under the guard: {guard}")
    if profile:
        print_profile("kwage-maestro-torch", t_dev, report)
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

    small = [truth_params[a] for a in accs[: ingest[0][2]]]
    print(f"phase 6 ingest: {len(accs)} accessions, {total_bp / 1e6:.1f} Mbp of {READ_LEN} bp "
          f"reads (data + ground truth {t_data:.1f} s); kwage-maestro-torch --device-build "
          f"--device-transpose {t_dev:.2f} s ({total_bp / 1e6 / t_dev:.2f} Mbp/s; "
          f"{guard['sorts']} fused sorts and {guard['builds']} accessions built alone, no "
          f"library sort of a CUDA tensor, no library compaction in them); "
          f"{len(accs)} .bloom == exact ground truth (L "
          f"{sorted({p.log_2_filter_len for p in truth_params.values()})}); "
          f"{len(dbs)} .db == host pack; --device search == host engine at -t 1.0 and 0.5; "
          f"golden digests reproduced; host native builder, {threads} threads, "
          f"{t_host:.2f} s ({total_bp / 1e6 / t_host:.2f} Mbp/s)", flush=True)
    genome_bp, coverage, count = ingest[0]
    rows = count * (genome_bp * coverage // READ_LEN)
    return {"rows": max(64, 1 << int(np.ceil(np.log2(rows)))),
            "blen": max(128, -(-READ_LEN // 128) * 128), "num_acc": count,
            "live_rows": rows, "valid_per_row": READ_LEN - INGEST_K + 1,
            "log2_len": small[0].log_2_filter_len, "num_hash": small[0].num_hash,
            # what phase 11 runs again and holds its output to
            "run": {"accs": accs, "truth": truth, "src": src, "bp": total_bp, "wall_s": t_dev,
                    "dbs": [os.path.basename(db) for db in dbs]}}


def run_chunked(work: str, device: torch.device, phase6: dict) -> dict:
    """Phase 12: phase 6's two 46 Mbp accessions through the port's
    build_bloom_device under the refusal, from their FASTQ paths (the
    native block) and from iterators of their reads (the string chunks the
    maestro's streams take), each first forced into chunks of CHUNK_BP
    bases (6 a file: each chunk after the first merges into the accumulator
    on the card), then with chunks sized from the card (one a file): every
    record == the exact ground truth. Then builds in threads on a full
    card: with all but CROWDED_FREE bytes of it taken, each accession twice
    from its path and once from an iterator, in 6 threads at once, chunks
    sized from what is left (several a file, each at its turn; without the
    turns, the path builds would all size theirs from the same reading):
    every record == the ground truth. Then the same two files from two
    processes at once (``run_two_process_builds``): each record == the
    ground truth, and the halving retry must fire in a child by the last
    round. Walls beside the native host builder's on the same two files (a
    thread each). Then the device memory a window of one chunk's
    count takes, the peak of count_chunk over its windows, on one whole
    accession and on a block of as many windows, all valid and distinct
    (the most a window takes), which make_bloom.BYTES_PER_WINDOW must
    cover; and merge_counts' peak over the words of the two, which
    make_bloom.MERGE_BYTES_PER_WORD must cover. Returns the shapes phase 4
    times run_counts and merge_counts at."""
    opts = BuildOptions(kmer_len=INGEST_K, min_kmer_count=MIN_COUNT)
    big = phase6["accs"][-INGEST[1][2]:]
    paths = [os.path.join(phase6["src"], f"{a}.fastq") for a in big]
    sources = {"path": lambda p: p, "iterator": torch_make_bloom._src_iter}

    def built(acc, rec, tag):
        param, bits, _ = phase6["truth"][acc]
        check(rec.param == param and rec.bits.tobytes() == bits.tobytes(),
              f"{acc}, {tag}: the record differs from the ground truth")

    walls = {}
    with no_library_sort() as guard:
        for route, source in sources.items():
            for tag, chunk_bp in (("forced", CHUNK_BP), ("card", None)):
                t0 = time.perf_counter()
                for acc, path in zip(big, paths):
                    built(acc, torch_make_bloom.build_bloom_device(
                        source(path), opts, FilterInfo(), chunk_bp=chunk_bp), f"{route}, {tag}")
                walls[route, tag] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        ballast = torch.empty(torch_make_bloom._card_free_bytes(device) - CROWDED_FREE,
                              dtype=torch.uint8, device=device)
        turns = [(acc, route) for acc in big for route in ("path", "path", "iterator")]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(turns)) as pool:
            recs = list(pool.map(lambda t: torch_make_bloom.build_bloom_device(
                sources[t[1]](paths[big.index(t[0])]), opts, FilterInfo()), turns))
        walls["crowded"] = time.perf_counter() - t0
        del ballast
        torch.cuda.empty_cache()
        for (acc, route), rec in zip(turns, recs):
            built(acc, rec, f"{route} on a crowded card")
    check(guard["builds"] == 4 * len(big) + len(turns), f"builds under the guard: {guard}")
    two = run_two_process_builds(work, device, paths)
    print("phase 12 two processes: " + "; ".join(
        f"{r['free']} B of the card free: 2 processes {r['wall_s']:.2f} s ("
        + ", ".join(f"child {i} {c['wall_s']:.2f} s, halved {c['halved']} time(s), waited "
                    f"{c['waited']} time(s) for memory, peak device memory "
                    f"{c['peak_bytes']} B, {c['builds']} builds"
                    + (f", {c['error']}" if c["error"] else "")
                    for i, c in enumerate(r["children"]))
        + f") beside the same {len(r['threads'])} builds in threads of one process "
          f"{r['threads_s']:.2f} s (halved {r['threads_halved']} time(s))" for r in two),
        flush=True)
    for r in two:
        for i, c in enumerate(r["children"]):
            check(c["error"] is None and c["builds"] == len(big) == len(c["records"]),
                  f"child {i} at {r['free']} B free: {c['error']} ({c['builds']} builds)")
            for acc, got in zip(big, c["records"]):
                param, bits, _ = phase6["truth"][acc]
                check(BloomParam(**got["param"]) == param
                      and np.fromfile(got["bits"], np.uint8).tobytes() == bits.tobytes(),
                      f"{acc}, child {i} at {r['free']} B free: the record differs from the "
                      f"ground truth")
        for acc, rec in zip(big * 2, r["threads"]):
            built(acc, rec, f"in threads at {r['free']} B free")
    check(any(c["halved"] for c in two[-1]["children"]),
          f"the halving retry never fired in two processes down to {two[-1]['free']} B free")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(lambda p: build_bloom_from_file(p, opts, FilterInfo()), paths))
    t_host = time.perf_counter() - t0

    def peak(fn):
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        torch.cuda.synchronize(device)
        return out, torch.cuda.max_memory_allocated(device) - base

    _, bp, packed, valid_words, blen, _ = torch_make_bloom._pack_file_block(paths[0], INGEST_K)
    windows = packed.shape[0] * (blen - INGEST_K + 1)
    real, real_peak = peak(lambda: torch_make_bloom.count_chunk(
        packed, valid_words, blen, INGEST_K, MIN_COUNT, 0))
    gen = torch.Generator(device=device).manual_seed(12)
    dense = torch.randint(-2**31, 2**31, packed.shape, generator=gen, device=device,
                          dtype=torch.int64).to(torch.int32)
    dense, dense_peak = peak(lambda: torch_make_bloom.count_chunk(
        dense, torch.full_like(valid_words, -1, device=device), blen, INGEST_K, MIN_COUNT, 0))
    nums = [int(real[2][0]), int(dense[2][0])]
    merged, merge_peak = peak(lambda: tcount.merge_counts(
        real[0][: nums[0]], real[1][: nums[0]], dense[0][: nums[1]], dense[1][: nums[1]],
        MIN_COUNT, MIN_COUNT))
    per_window = [real_peak / windows, dense_peak / windows]
    per_word = merge_peak / sum(nums)
    check(int(merged[2][0]) <= sum(nums), f"merge_counts gave {merged[2].tolist()} of {nums}")
    del real, dense, merged
    print(f"phase 12 chunked: build_bloom_device of 2 accessions of {bp / 1e6:.1f} Mbp, "
          f"chunk_bp={CHUNK_BP} ({-(-bp // CHUNK_BP)} chunks each, merged on the card) / chunks "
          f"from the card (one each): from their FASTQ paths {walls['path', 'forced']:.2f} / "
          f"{walls['path', 'card']:.2f} s, from iterators of their reads "
          f"{walls['iterator', 'forced']:.2f} / {walls['iterator', 'card']:.2f} s; "
          f"{len(turns)} builds in threads with {CROWDED_FREE} B of the card free "
          f"{walls['crowded']:.2f} s; the native host builder (a thread a file) {t_host:.2f} s; "
          f"{guard['builds']} builds == exact ground truth, no library sort or compaction of a "
          f"CUDA tensor in them; a chunk's count {per_window[0]:.2f} B of device memory a window "
          f"({windows} windows of [{packed.shape[0]}, {blen}], {nums[0]} distinct k-mers), "
          f"{per_window[1]:.2f} B a window all valid ({nums[1]} distinct); merge_counts "
          f"{per_word:.2f} B a word", flush=True)
    check(max(per_window) <= torch_make_bloom.BYTES_PER_WINDOW,
          f"a chunk's count took {per_window} B a window, over make_bloom.BYTES_PER_WINDOW")
    check(per_word <= torch_make_bloom.MERGE_BYTES_PER_WORD,
          f"a merge took {per_word:.2f} B a word, over make_bloom.MERGE_BYTES_PER_WORD")
    return {"windows": packed.shape[0] * (READ_LEN - INGEST_K + 1), "distinct": nums[0],
            "chunks": -(-bp // CHUNK_BP)}


def build_child(argv: list[str]) -> int:
    """A process of phase 12's two-process step (``run_two_process_builds``):
    ``argv`` is a file prefix and the FASTQ paths. It reaches the card and
    loads both libraries, prints READY, then for each line on stdin (a
    round's name) builds every path with ``build_bloom_device`` (chunks from
    the card) under phase 6's refusals, writes each record's bits to
    PREFIX.ROUND.I and prints one DONE line: the records' params and files,
    the round's wall, how many times each retry of the chunk loop fired
    (``make_bloom.retry_counts()``), the peak device memory, and the error
    that ended a build and where, if one did."""
    prefix, paths = argv[0], argv[1:]
    device = resolve_device()
    torch.zeros(1, device=device)
    if device.type == "cuda":
        kernels.get_lib()
    native_available()
    opts = BuildOptions(kmer_len=INGEST_K, min_kmer_count=MIN_COUNT)
    print("READY", flush=True)
    for line in sys.stdin:
        name = line.strip()
        torch_make_bloom.reset_retry_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        report = {"round": name, "records": [], "error": None}
        t0 = time.perf_counter()
        with no_library_sort() as guard:
            try:
                for i, path in enumerate(paths):
                    rec = torch_make_bloom.build_bloom_device(path, opts, FilterInfo())
                    rec.bits.tofile(f"{prefix}.{name}.{i}")
                    report["records"].append({"bits": f"{prefix}.{name}.{i}",
                                              "param": dataclasses.asdict(rec.param)})
            except RuntimeError as e:      # torch.cuda.OutOfMemoryError among them
                report["error"] = (f"{type(e).__name__}: {e} at "
                                   + " < ".join(f"{f.name}:{f.lineno}" for f in reversed(
                                       traceback.extract_tb(e.__traceback__))))
        report.update(wall_s=time.perf_counter() - t0, builds=guard["builds"],
                      **torch_make_bloom.retry_counts(),
                      peak_bytes=(torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print("DONE " + json.dumps(report), flush=True)
    return 0


def run_two_process_builds(work: str, device: torch.device, paths: list[str],
                           frees=TWO_PROCESS_FREE) -> list[dict]:
    """Phase 12's device builds from two processes on one crowded card: two
    ``build_child`` processes, up and holding the libraries first; then a
    round for each entry of ``frees``: this process holds all but that many
    bytes of the card, releases both children at once (each builds every
    path of ``paths``, chunks from the card) and times them to the last
    DONE, then the same builds in threads of this process (each path
    twice, one thread a build) under the same ballast, all under phase 6's
    refusals. Nothing is shared between the processes but the card. The
    rounds stop at the first where a child's halving retry fired. Returns
    a round a dict: the free bytes, the two walls, the children's DONE
    reports and the records built in threads."""
    opts = BuildOptions(kmer_len=INGEST_K, min_kmer_count=MIN_COUNT)
    out = os.path.join(work, "two_process")
    os.makedirs(out, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(out, f"child{i}.log"), "w") for i in range(2)]
    children = [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.build_child("
         "sys.argv[1:]))", os.path.join(out, f"child{i}"), *paths],
        cwd=here, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log, text=True)
        for i, log in enumerate(logs)]

    def tail(i: int) -> str:
        logs[i].flush()
        with open(logs[i].name) as f:
            return f.read()[-3000:]

    rounds = []
    try:
        for i, child in enumerate(children):
            check(child.stdout.readline().strip() == "READY",
                  f"the build child {i} did not come up: {tail(i)}")
        for free in frees:
            ballast = None
            if device.type == "cuda":
                torch.cuda.empty_cache()
                ballast = torch.empty(torch_make_bloom._card_free_bytes(device) - free,
                                      dtype=torch.uint8, device=device)
            t0 = time.perf_counter()
            for child in children:
                child.stdin.write(f"r{len(rounds)}\n")
                child.stdin.flush()
            reports = []
            for i, child in enumerate(children):
                line = child.stdout.readline()
                check(line.startswith("DONE "), f"the build child {i} failed: {tail(i)}")
                reports.append(json.loads(line[len("DONE "):]))
            wall = time.perf_counter() - t0
            torch_make_bloom.reset_retry_counts()
            t0 = time.perf_counter()
            with no_library_sort(), ThreadPoolExecutor(2 * len(paths)) as pool:
                recs = list(pool.map(lambda p: torch_make_bloom.build_bloom_device(
                    p, opts, FilterInfo()), paths * 2))
            rounds.append({"free": free, "wall_s": wall,
                           "threads_s": time.perf_counter() - t0, "children": reports,
                           "threads_halved": torch_make_bloom.retry_counts()["halved"],
                           "threads": recs})
            del ballast
            if any(r["halved"] for r in reports):
                break
    finally:
        for child in children:
            if child.stdin and not child.stdin.closed:
                child.stdin.close()
        for child in children:
            try:
                child.wait(timeout=60)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
        for log in logs:
            log.close()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rounds


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
    read comes from), half random, and one read of each SR_EDGE_BP from
    those last subjects (below their 100-match cap), in random places.
    Returns (queries, reads, bases)."""
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
    places = rng.choice(n_reads, size=SR_LONG + len(SR_EDGE_BP), replace=False).tolist()
    for j, pos in enumerate(places[:SR_LONG]):
        if j % 2 == 0:
            g = genomes[SR_SUBJECTS - SR_LONG_ONLY + (j // 2) % SR_LONG_ONLY]
            a = int(rng.integers(0, SR_SUBJECT_BP - SR_LONG_BP + 1))
            longs[pos] = ACGT[mutate(rng, g[a : a + SR_LONG_BP])].tobytes()
        else:
            longs[pos] = ACGT[rng.integers(0, 4, size=SR_LONG_BP)].tobytes()
    for j, (pos, n) in enumerate(zip(places[SR_LONG:], SR_EDGE_BP)):
        g = genomes[SR_SUBJECTS - SR_LONG_ONLY + j % SR_LONG_ONLY]
        a = int(rng.integers(0, SR_SUBJECT_BP - n + 1))
        longs[pos] = ACGT[mutate(rng, g[a : a + n])].tobytes()
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


def device_and_host(work: str, device: torch.device, tag: str, args: list[str],
                    profile: bool = False, host_threads: int = 1) -> tuple:
    """One run of kwage-sriracha-torch with ``args``: with --device, then
    without it (the port's host engine, in ``host_threads`` threads: the
    reference's local-file split, the same bytes); the two TSVs must be
    the same bytes. ``profile``: also time the read iterator and the
    SRIRACHA_STEPS functions, trace the device (``step_profile``) and print
    the breakdown. Returns (the --device TSV's bytes, its path, its wall
    seconds, the host's, the launches of the --device run by kernel, its
    profile)."""
    before = kernels.launch_counts()
    steps = step_profile(device, SRIRACHA_STEPS) if profile else contextlib.nullcontext()
    with steps as report, sriracha_profile(profile) as prof:
        t0 = time.perf_counter()
        rc = torch_sriracha_main(args + ["--device", "-o", os.path.join(work, "dev.tsv")])
        t_dev = time.perf_counter() - t0
    check(rc == 0, f"kwage-sriracha-torch exited {rc}")
    tsv = os.path.join(work, f"dev_{tag}.tsv")
    os.replace(os.path.join(work, "dev.tsv"), tsv)
    if profile:
        print(f"profile: run {tag} kwage-sriracha-torch --device {t_dev:.3f} s under the "
              f"step timers and the profiler; device busy {report['busy_s']:.4f} s, idle "
              f"share {1 - report['busy_s'] / t_dev:.4f}")
        for name, secs, calls in report["steps"]:
            print(f"profile step {name:<40} {secs:8.3f} s  x{calls}")
        print(report["table"], flush=True)
    after = kernels.launch_counts()
    t0 = time.perf_counter()
    rc = torch_sriracha_main(args + ["--threads", str(host_threads), "-o",
                                     os.path.join(work, "host.tsv")])
    t_host = time.perf_counter() - t0
    check(rc == 0, f"host sriracha exited {rc}")
    with open(tsv, "rb") as f:
        dev = f.read()
    with open(os.path.join(work, "host.tsv"), "rb") as f:
        check(dev == f.read(), f"run {tag} ({' '.join(args[:4])}): --device TSV differs from "
              f"the host engine's")
    return dev, tsv, t_dev, t_host, {n: after[n] - before[n] for n in after}, prof


def run_sriracha(work: str, device: torch.device, seed: int, runs=SR_RUNS,
                 profile: bool = False) -> dict:
    """Phase 8's short-read runs through the port's kwage-sriracha-torch
    --device, each against the host engine's bytes (``device_and_host``);
    on a card, each run must launch its route's kernels and not the
    other's. Returns, by run tag, what phase 10 runs again and holds its
    output to: (k, threshold, queries, reads, bases, the --device TSV's
    path, its wall seconds, its profile)."""
    data, done = {}, {}
    for tag, k, t, n_reads in runs:
        if n_reads not in data:  # a run cut to fewer reads gets data of its own
            t0 = time.perf_counter()
            data[n_reads] = make_sriracha_data(work, np.random.default_rng(seed + 4), n_reads)
            print(f"phase 8 data: {SR_SUBJECTS} queries x {SR_SUBJECT_BP} bp, {n_reads} reads "
                  f"+ {SR_LONG} of {SR_LONG_BP} bp + one of each {SR_EDGE_BP} bp, "
                  f"{data[n_reads][2] / 1e6:.1f} Mbp "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        queries, path, bp = data[n_reads]
        args = ["-k", str(k), "-t", str(t), "-i", queries, path]
        dev, tsv, t_dev, t_host, launched, prof = device_and_host(work, device, tag, args,
                                                                  profile, HOST_THREADS)
        probe, other = ("lut", "hash") if k <= 13 else ("hash", "lut")
        route = [f"sriracha_reads_{probe}", f"sriracha_counts_{probe}"]
        check(device.type != "cuda" or (
            all(launched[n] > 0 for n in route)
            and not any(launched[f"sriracha_{n}_{other}"] for n in ("reads", "block", "counts"))),
              f"run {tag} (k={k}) did not take the {probe} route: {launched}")
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
        edges = sorted({len(r[3]) for r in rows} & set(SR_EDGE_BP))
        check(edges == SR_EDGE_BP, f"run {tag}: of the edge reads {SR_EDGE_BP} bp, {edges} listed")
        shown = {k2: round(v, 3) for k2, v in prof.items() if k2.endswith("_s")}
        print(f"phase 8 sriracha run {tag}: k={k} -t {t}, {n_reads} reads + {SR_LONG} long, "
              f"{bp / 1e6:.1f} Mbp; --device {t_dev:.2f} s ({bp / 1e6 / t_dev:.2f} Mbp/s, "
              + ", ".join(f"{launched[n]} {n}" for n in [*route, "canonical_kmers"])
              + f" launches, profile {shown}, "
              f"{prof.get('spans')} spans); host engine in {HOST_THREADS} threads {t_host:.2f} "
              f"s ({bp / 1e6 / t_host:.2f} Mbp/s); TSV == host bytes, {len(rows)} rows, "
              f"{perfect} with score 1", flush=True)
        done[tag] = (k, t, queries, path, bp, tsv, t_dev, shown)
    return done


def make_long_read_data(work: str, rng) -> tuple[str, str, int]:
    """Query FASTA of SR_SUBJECTS genomes of SR_SUBJECT_BP and one FASTQ of
    LR_READS long reads in random order: half amplicons of LR_AMPLICON_BP
    (+- LR_AMPLICON_SPREAD) from random places of random subjects, half
    genomic reads log-uniform in LR_GENOMIC_BP, a third of them from the
    subjects and the rest random, plus LR_EDGES (the buckets' edges);
    every read drawn from a subject with SUB_RATE substitutions on a random
    strand, N_RATE of the bases N and one read in ten with a run of 1-30 N.
    Returns (queries, reads, bases)."""
    genomes = rng.integers(0, 4, size=(SR_SUBJECTS, SR_SUBJECT_BP), dtype=np.uint8)
    queries = os.path.join(work, "long_queries.fasta")
    with open(queries, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(b">query %d\n" % i + ACGT[g].tobytes() + b"\n")
    half = LR_READS // 2
    lo, hi = LR_GENOMIC_BP
    lengths = np.concatenate([
        LR_AMPLICON_BP + rng.integers(-LR_AMPLICON_SPREAD, LR_AMPLICON_SPREAD + 1, size=half),
        np.exp(rng.uniform(np.log(lo), np.log(hi), size=LR_READS - half - len(LR_EDGES)))
        .astype(np.int64), LR_EDGES])
    from_subject = np.concatenate([np.ones(half, bool),
                                   rng.random(LR_READS - half) < 1 / 3])
    order = rng.permutation(LR_READS)
    path = os.path.join(work, f"SRR8{LR_READS:06d}.fastq")
    total = 0
    with open(path, "wb") as f:
        for i, r in enumerate(order):
            n = int(lengths[r])
            if from_subject[r]:
                g = genomes[int(rng.integers(0, SR_SUBJECTS))]
                a = int(rng.integers(0, SR_SUBJECT_BP - n + 1))
                seq = ACGT[mutate(rng, g[a : a + n])]
            else:
                seq = ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)]
            seq[rng.random(n) < N_RATE] = ord("N")
            if rng.random() < 0.1:
                a = int(rng.integers(0, n))
                seq[a : a + int(rng.integers(1, 31))] = ord("N")
            total += n
            f.write(b"@l%d\n%s\n+\n%s\n" % (i, seq.tobytes(), b"I" * n))
    return queries, path, total


def run_sriracha_long(work: str, device: torch.device, seed: int, runs=LR_RUNS) -> dict:
    """Phase 8's long-read runs (``make_long_read_data``: reads of 1-16 kbp,
    every one in a bucket of 1024-16384 bases) through kwage-sriracha-torch
    --device, each against the host engine's bytes; on a card each run must
    launch its probe's sriracha_block kernel and none of canonical_kmers,
    sriracha_counts, sriracha_reads or the other probe's. Every subject
    must be listed (its amplicons), some reads with score 1. Returns what
    run_sriracha returns, by run tag."""
    t0 = time.perf_counter()
    queries, path, bp = make_long_read_data(work, np.random.default_rng(seed + 6))
    print(f"phase 8 long-read data: {SR_SUBJECTS} queries x {SR_SUBJECT_BP} bp, {LR_READS} "
          f"reads, {bp / 1e6:.1f} Mbp ({time.perf_counter() - t0:.1f} s)", flush=True)
    done = {}
    for tag, k, t in runs:
        args = ["-k", str(k), "-t", str(t), "-i", queries, path]
        dev, tsv, t_dev, t_host, launched, prof = device_and_host(
            work, device, tag, args, host_threads=HOST_THREADS)
        probe = "lut" if k <= 13 else "hash"
        route = f"sriracha_block_{probe}"
        others = [n for n in launched if n != route and n != "subject_table" and launched[n]]
        check(device.type != "cuda" or (launched[route] > 0 and not others),
              f"run {tag} (k={k}) did not take {route} alone: {launched}")
        rows = [line.split(b"\t") for line in dev.splitlines() if b"\t" in line]
        per_query = collections.Counter(r[4] for r in rows)
        perfect = sum(1 for r in rows if r[2] == b"1")
        check(len(per_query) == SR_SUBJECTS and perfect > 0,
              f"run {tag}: {len(rows)} rows over {len(per_query)} queries, {perfect} perfect")
        shown = {k2: round(v, 3) for k2, v in prof.items() if k2.endswith("_s")}
        print(f"phase 8 sriracha long-read run {tag}: k={k} -t {t}, {LR_READS} reads of 1-16 "
              f"kbp, {bp / 1e6:.1f} Mbp; --device {t_dev:.2f} s ({bp / 1e6 / t_dev:.2f} Mbp/s, "
              f"{launched[route]} {route} launches, profile {shown}, {prof.get('spans')} "
              f"spans); host engine in {HOST_THREADS} threads {t_host:.2f} s "
              f"({bp / 1e6 / t_host:.2f} Mbp/s); TSV == host bytes, {len(rows)} rows, {perfect} "
              f"with score 1", flush=True)
        done[tag] = (k, t, queries, path, bp, tsv, t_dev, shown)
    return done


def run_sriracha_phase(work: str, device: torch.device, seed: int) -> dict:
    """Phase 8: the short-read runs (``run_sriracha``), then the long-read
    runs (``run_sriracha_long``); what both return, by run tag."""
    return {**run_sriracha(work, device, seed), **run_sriracha_long(work, device, seed)}


# --- phase 10: SriRachA over a mesh of slots ----------------------------------------------

def run_sriracha_mesh(work: str, device: torch.device, phase8: dict,
                      slots: int = READ_MESH_SLOTS) -> None:
    """Phase 10 over phase 8's data (``phase8``: run_sriracha's result):
    each run through the port's search_reads_device on a mesh of ``slots``
    logical slots of the card (and on every card where there are several),
    then once through ``kwage-sriracha-torch --device`` with the card listed
    ``slots`` times as the visible devices. Every TSV must equal phase 8's
    single-device bytes (which equal the host engine's)."""
    cards = [torch.device(device.type, i) for i in range(torch.cuda.device_count())] \
        if device.type == "cuda" else [device]
    meshes = [("slots", [device] * slots)] + ([("cards", cards)] if len(cards) > 1 else [])
    seen = []
    read_slots = tsr.read_slots

    def recorded(*args, **kwargs):
        seen.append(read_slots(*args, **kwargs))
        return seen[-1]

    tsr.read_slots = recorded
    try:
        for tag, (k, t, queries, path, bp, tsv, t_one, prof_one) in phase8.items():
            with open(tsv, "rb") as f:
                want = f.read()
            opt = SrirachaOptions(kmer_len=k, kmer_match_threshold=t)
            for name, mesh in meshes:
                prof: dict = {}
                del seen[:]
                t0 = time.perf_counter()
                subjects = load_subject_kmers([queries], k)
                results = tsr.search_reads_device(iter_reads_range(path, 0, 1), subjects, opt,
                                                  StreamStats(), mesh=mesh, profile=prof)
                got = (format_results(path, subjects, results) + "//\n").encode()
                wall = time.perf_counter() - t0
                check(got == want, f"run {tag} on a mesh of {len(mesh)} ({name}): TSV differs "
                      f"from phase 8's")
                check([len(x) for x in seen] == [len(mesh)], f"run {tag}: slots {seen}")
                shown = {k2: round(v, 3) for k2, v in prof.items() if k2.endswith("_s")}
                print(f"phase 10 sriracha mesh run {tag}: search_reads_device on {len(mesh)} "
                      f"{name} {wall:.2f} s ({bp / 1e6 / wall:.2f} Mbp/s, profile {shown}, "
                      f"{prof['spans']} spans) beside phase 8's one device {t_one:.2f} s "
                      f"({bp / 1e6 / t_one:.2f} Mbp/s, profile {prof_one}); TSV == phase 8's",
                      flush=True)
            del seen[:]
            out = os.path.join(work, f"mesh_{tag}.tsv")
            saved = tmesh.default_devices
            tmesh.default_devices = lambda: [device] * slots
            try:
                with sriracha_profile() as prof:
                    t0 = time.perf_counter()
                    rc = torch_sriracha_main(["-k", str(k), "-t", str(t), "-i", queries, path,
                                              "--device", "-o", out])
                    wall = time.perf_counter() - t0
            finally:
                tmesh.default_devices = saved
            check(rc == 0, f"kwage-sriracha-torch --device over {slots} slots exited {rc}")
            with open(out, "rb") as f:
                check(f.read() == want, f"run {tag}: the CLI's TSV over {slots} slots differs "
                      f"from phase 8's")
            check([len(x) for x in seen] == [slots], f"run {tag}: the CLI took slots {seen}")
            shown = {k2: round(v, 3) for k2, v in prof.items() if k2.endswith("_s")}
            print(f"phase 10 sriracha mesh run {tag}: kwage-sriracha-torch --device with "
                  f"{slots} default devices {wall:.2f} s ({bp / 1e6 / wall:.2f} Mbp/s, profile "
                  f"{shown}); TSV == phase 8's", flush=True)
    finally:
        tsr.read_slots = read_slots


# --- phase 11: the ingest through the cross-host work queue ------------------------------

# The --worker process: it reaches the card (and loads the kernels) first,
# says so in the file argv[1], then waits on stdin for the address its
# coordinator bound and runs kwage-maestro-torch with the rest of argv and
# --worker at that address. It prints its peak device memory and its kernel
# launches to stderr.
REMOTE_WORKER = """
import json, sys
import torch
from kwage_tpu_torch import kernels
from kwage_tpu_torch.cli.maestro import main
from kwage_tpu_torch.utils.runtime import resolve_device
ready, argv = sys.argv[1], sys.argv[2:]
dev = resolve_device()
if dev.type == "cuda":
    torch.zeros(1, device=dev)
    kernels.get_lib()
open(ready, "w").close()
address = sys.stdin.readline()
if not address.endswith("\\n"):
    sys.exit(3)     # the parent went away before the release
rc = main(argv + ["--worker", address.strip()])
peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
print(f"worker peak device memory {peak} B", file=sys.stderr)
print("worker launches " + json.dumps(kernels.launch_counts()), file=sys.stderr)
sys.exit(rc)
"""


class ListeningTee(io.TextIOBase):
    """sys.stderr while a coordinator runs in this process: every write goes
    on to ``out``; the coordinator's ``LISTENING`` line (the address it
    bound, port 0 asked for) is handed once to ``release``."""

    def __init__(self, out, release):
        self.out, self.release, self.address = out, release, None
        self._line, self._lock = "", threading.Lock()

    def write(self, text: str) -> int:
        self.out.write(text)
        with self._lock:
            if self.address is None:
                self._line += text
                *lines, self._line = self._line.split("\n")
                for line in lines:
                    if line.startswith(LISTENING):
                        self.address = line[len(LISTENING):].strip()
                        self.release(self.address)
                        break
        return len(text)

    def flush(self) -> None:
        self.out.flush()


def run_remote_ingest(work: str, device: torch.device, phase6: dict,
                      profile: bool = False) -> dict:
    """Phase 11 over phase 6's accessions (``phase6``: run_ingest's
    ``run``): ``kwage-maestro-torch --coordinator 127.0.0.1:0`` with its 2
    local workers and one ``kwage-maestro-torch --worker`` process, all
    with --device-build --device-transpose on the same card. The worker
    process is up before the coordinator starts, and is released with the
    address the coordinator bound and printed (no port is freed and handed
    on). Every .bloom and .db must equal phase 6's bytes (the .bloom files
    its exact ground truth too) and the status file must show every
    accession done. Returns the worker process's kernel launches (this
    process counts its own). ``profile``: break this process's share of the
    call down (``step_profile``)."""
    remote = os.path.join(work, "remote")
    os.makedirs(remote)
    common = ["--meta", os.path.join(work, "inv.bin"), "--scratch", remote,
              "--status", os.path.join(remote, "status.bin"), "--source-dir", phase6["src"],
              "-k", str(INGEST_K), "--min-kmer-count", str(MIN_COUNT), "--device-build",
              "--device-transpose", "--device-batch", str(REMOTE_BATCH), "--save.bloom"]
    ready, log = os.path.join(remote, "worker.ready"), os.path.join(remote, "worker.log")
    with open(log, "w") as err:
        worker = subprocess.Popen(
            [sys.executable, "-c", REMOTE_WORKER, ready, *common],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdin=subprocess.PIPE,
            stderr=err, text=True)

    def release(address: str) -> None:
        worker.stdin.write(address + "\n")
        worker.stdin.close()

    try:
        t0 = time.perf_counter()
        while not os.path.exists(ready):
            check(worker.poll() is None and time.perf_counter() - t0 < 300,
                  "the --worker process did not come up")
            time.sleep(0.1)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        tee = ListeningTee(sys.stderr, release)
        with (step_profile(device, INGEST_STEPS) if profile else contextlib.nullcontext()) \
                as report, no_library_sort() as guard, contextlib.redirect_stderr(tee):
            t0 = time.perf_counter()
            rc = torch_maestro_main(common + ["--workers", "2", "--task-timeout", "600",
                                              "--coordinator", "127.0.0.1:0"])
            wall = time.perf_counter() - t0
        check(tee.address is not None, "the coordinator printed no address")
        worker_rc = worker.wait(timeout=300)
    finally:
        if not worker.stdin.closed:
            worker.stdin.close()
        if worker.poll() is None:
            worker.kill()
            worker.wait()
    with open(log) as f:
        worker_log = f.read()
    if profile:
        print_profile("kwage-maestro-torch --coordinator", wall, report)
    check(rc == 0, f"kwage-maestro-torch --coordinator exited {rc}")
    check(worker_rc == 0, f"kwage-maestro-torch --worker exited {worker_rc}: {worker_log[-2000:]}")
    found = re.search(r"Worker finished \((\d+) tasks\)", worker_log)
    peak = re.search(r"worker peak device memory (\d+) B", worker_log)
    launches = re.search(r"worker launches (\{.*\})", worker_log)
    check(bool(found and peak and launches), f"worker log: {worker_log[-2000:]}")
    accs, truth = phase6["accs"], phase6["truth"]
    status, _ = read_status_file(os.path.join(remote, "status.bin"), len(accs))
    check(bool((status == STATUS_DATABASE_SUCCESS).all()), f"statuses {status.tolist()}")
    for acc in accs:
        got = os.path.join(remote, "bloom", f"{acc}.bloom")
        check(sha256(got) == sha256(os.path.join(work, "bloom", f"{acc}.bloom")),
              f"{acc}: the remote .bloom differs from phase 6's")
        rec = read_bloom_file(got)
        param, bits, _ = truth[acc]
        check(rec.param == param and rec.bits.tobytes() == bits.tobytes(),
              f"{acc}: the remote .bloom differs from the ground truth")
    dbs = sorted(os.listdir(os.path.join(remote, "database")))
    check(dbs == sorted(phase6["dbs"]), f"remote .db files {dbs} != phase 6's {phase6['dbs']}")
    for db in dbs:
        check(sha256(os.path.join(remote, "database", db))
              == sha256(os.path.join(work, "database", db)), f"{db}: differs from phase 6's")
    peak_here = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bp = phase6["bp"]
    print(f"phase 11 remote ingest: kwage-maestro-torch --coordinator (2 local workers) + one "
          f"--worker process, --device-build --device-transpose --device-batch {REMOTE_BATCH}: "
          f"{wall:.2f} s ({bp / 1e6 / wall:.2f} Mbp/s) beside phase 6's {phase6['wall_s']:.2f} s "
          f"({bp / 1e6 / phase6['wall_s']:.2f} Mbp/s); the worker process ran {found.group(1)} "
          f"tasks; peak device memory {peak_here} B here, {peak.group(1)} B in the worker; "
          f"{guard['sorts']} fused sorts and {guard['builds']} accessions built alone here, no "
          f"library sort of a CUDA tensor, no library compaction in them; {len(accs)} .bloom "
          f"and {len(dbs)} .db == phase 6's bytes and ground truth; every accession done",
          flush=True)
    return json.loads(launches.group(1))


# --- phase 14: the production-L path (L=26, a full quota file) ----------------------

def db_tail(infos, info_start: int) -> bytes:
    """What a .db holds after its slices (io.db_file.write_db_file_streaming):
    the FilterInfo records' absolute offsets, then the records."""
    records = io.BytesIO()
    locs = []
    for info in infos:
        locs.append(info_start + 8 * len(infos) + records.tell())
        BinaryWriter(records).filter_info(info)
    return struct.pack(f"<{len(infos)}Q", *locs) + records.getvalue()


def bloom_data_offset(path: str) -> int:
    """Where a .bloom file's filter bits start (after its magic, shape,
    crc32 and FilterInfo record)."""
    with open(path, "rb") as f:
        r = BinaryReader(f)
        r.u8()
        r.bloom_param()
        r.u32()
        r.filter_info()
        return f.tell()


PACK_AHEAD = 4   # host chunks transposed ahead, each ~1.5 GiB of host memory at L=26


def host_pack_sha256(db_path: str, param: BloomParam, blooms: list[str],
                     chunk_bits: int = torch_build_db.DEFAULT_CHUNK_BITS) -> tuple[str, str]:
    """(the sha256 of the .db that the host pack -- ``build_db_from_bloom_files``
    without a device -- writes from ``blooms``, the sha256 of ``db_path``).
    The host pack's digest is computed chunk by chunk with
    ``transpose_filters`` and never written: PACK_AHEAD chunks transpose
    ahead in threads (a .bloom listed many times is read once a chunk),
    the main thread hashes them in order. A thread reads ``db_path`` beside
    it; each chunk's crc32 must equal that of the same rows of the file,
    and the header the host pack would write must equal the file's."""
    rank = {p: i for i, p in enumerate(dict.fromkeys(blooms))}
    distinct, where = list(rank), np.array([rank[p] for p in blooms])
    offsets = [bloom_data_offset(p) for p in distinct]
    filter_bytes, chunk_bytes = param.filter_len // 8, chunk_bits // 8
    starts = list(range(0, filter_bytes, chunk_bytes))
    slice_size = -(-len(blooms) // 8)

    def transposed(start: int) -> np.ndarray:
        n = min(chunk_bytes, filter_bytes - start)
        rows = np.empty((len(distinct), n), np.uint8)
        for i, (path, off) in enumerate(zip(distinct, offsets)):
            with open(path, "rb") as f:
                f.seek(off + start)
                rows[i] = np.frombuffer(f.read(n), np.uint8)
        return np.ascontiguousarray(torch_build_db.transpose_filters(rows[where], len(blooms)))

    def file_side() -> tuple[str, list[int]]:
        with open(db_path, "rb") as f:
            digest = hashlib.sha256(f.read(HEADER_SIZE))
            crcs = []
            for start in starts:
                data = f.read(min(chunk_bytes, filter_bytes - start) * 8 * slice_size)
                digest.update(data)
                crcs.append(zlib.crc32(data))
            for block in iter(lambda: f.read(1 << 24), b""):
                digest.update(block)
        return digest.hexdigest(), crcs

    with open(db_path, "rb") as f:
        header = f.read(HEADER_SIZE)
    digest = hashlib.sha256(header)
    crc, crcs = 0, []
    with ThreadPoolExecutor(PACK_AHEAD + 1) as pool:
        side = pool.submit(file_side)
        ahead = collections.deque(pool.submit(transposed, st) for st in starts[:PACK_AHEAD])
        for i in range(len(starts)):
            chunk = ahead.popleft().result()
            if i + PACK_AHEAD < len(starts):
                ahead.append(pool.submit(transposed, starts[i + PACK_AHEAD]))
            digest.update(chunk)
            crc = zlib.crc32(chunk, crc)
            crcs.append(zlib.crc32(chunk))
            del chunk
        file_sha, file_crcs = side.result()
    bad = [i for i, (a, b) in enumerate(zip(crcs, file_crcs)) if a != b]
    check(not bad, f"{db_path}: chunks {bad} of {chunk_bits} bits differ from the host pack's")
    hdr = DBFileHeader(kmer_len=param.kmer_len, num_hash=param.num_hash,
                       log_2_filter_len=param.log_2_filter_len, num_filter=len(blooms),
                       hash_func=param.hash_func, crc32=crc & 0xFFFFFFFF)
    hdr.info_start = HEADER_SIZE + hdr.filter_len * hdr.slice_size
    check(hdr.pack() == header, f"{db_path}: header differs from the host pack's")
    digest.update(db_tail([read_bloom_file(p, with_bits=False).info for p in blooms],
                          hdr.info_start))
    return digest.hexdigest(), file_sha


def complete_reads(fasta: str, kept: np.ndarray, n: int) -> list[str]:
    """The first ``n`` reads of ``fasta`` whose every k-mer the exact count
    kept: a filter has no false negatives, so each is a complete match of
    its accession."""
    out = []
    for read in scale_corpus.fasta_reads(fasta):
        if np.isin(canonical_kmers_native(read.tobytes(), KMER_LEN), kept).all():
            out.append(read.tobytes().decode())
            if len(out) == n:
                break
    check(len(out) == n, f"{fasta}: fewer than {n} reads with every k-mer kept")
    return out


def run_prod_l(work: str, device: torch.device, seed: int, log2_len: int = PROD_L,
               n_acc: int = PROD_ACC, copies: int = PROD_COPIES,
               genome_bp: int = PROD_GENOME, resident_budget: int = PROD_RESIDENT_BUDGET,
               mesh_budget: int = PROD_MESH_BUDGET) -> dict:
    """Phase 14 through the port's entry points; returns the L=26 build's
    shape for phase 4. Runs on any torch device (on the CPU with the plain
    versions, at a small L; the card is where it counts)."""
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    filter_bytes = (1 << log2_len) // 8
    full_bytes = n_acc * copies * filter_bytes
    # Disk: the full file, the .bloom files, the partial and room to
    # spare (40 GiB at L=26); memory: the full file's pages stay cached
    # between its searches, and the packs' 512 MiB blocks beside them.
    machine = scale_corpus.require_machine(work, full_bytes * 5 // 2, full_bytes * 3 // 2)

    # 1. The build at L=26: the prodL corpus's first accessions.
    t0 = time.perf_counter()
    # The planted 400 bp queries: 4 accessions spread over the build.
    corpus = scale_corpus.generate(work, n_acc, genome_bp, 4, seed=1, prefix="SRR8",
                                   query_at=tuple(i * (n_acc - 1) // 3 for i in range(4)))
    truth = {acc: exact_bloom(scale_corpus.fasta_reads(os.path.join(corpus.src, f"{acc}.fasta")),
                              KMER_LEN, PROD_MIN_COUNT, min_log_2_filter_len=log2_len,
                              max_log_2_filter_len=log2_len)
             for acc in corpus.accessions}
    t_data = time.perf_counter() - t0
    with no_library_sort() as guard:
        t0 = time.perf_counter()
        rc = torch_maestro_main([
            "--meta", corpus.inv, "--scratch", work, "--status", os.path.join(work, "status.bin"),
            "--source-dir", corpus.src, "-k", str(KMER_LEN), "--min-kmer-count",
            str(PROD_MIN_COUNT), "--len.min", str(log2_len), "--len.max", str(log2_len),
            "--device-build", "--device-transpose", "--workers", "2", "--save.bloom"])
        t_build = time.perf_counter() - t0
    check(rc == 0, f"kwage-maestro-torch exited {rc}")
    check(guard["sorts"] > 0, f"no sort_valid_windows call ran under the guard: {guard}")
    blooms = [os.path.join(work, "bloom", f"{acc}.bloom") for acc in corpus.accessions]
    for acc, path in zip(corpus.accessions, blooms):
        rec = read_bloom_file(path)
        param, bits, _ = truth[acc]
        check(rec.param == param and rec.bits.tobytes() == bits.tobytes() and rec.test_crc32(),
              f"{acc}: the L={log2_len} .bloom differs from the exact ground truth")
    dbs = sorted(os.listdir(os.path.join(work, "database")))
    check(len(dbs) == 1, f"expected one partial .db, got {dbs}")
    partial = os.path.join(work, "database", dbs[0])
    reader = open_database(partial)
    param = reader.header.param
    check(param.log_2_filter_len == log2_len and reader.header.num_filter == n_acc,
          f"partial .db: {reader.header}")
    members = [accession_to_str(reader.read_filter_info(i).run_accession) for i in range(n_acc)]
    host_partial = os.path.join(work, "host_partial.db")
    build_db_from_bloom_files(host_partial, param,
                              [os.path.join(work, "bloom", f"{a}.bloom") for a in members])
    check(sha256(partial) == sha256(host_partial), "the partial .db differs from the host pack")
    os.remove(host_partial)
    print(f"phase 14 build: {n_acc} accessions x {corpus.bp_per_acc} bp (data + ground truth "
          f"{t_data:.1f} s), kwage-maestro-torch --device-build --device-transpose --len.min "
          f"{log2_len} --len.max {log2_len} {t_build:.2f} s ({n_acc / t_build:.2f} filters/s; "
          f"{guard['sorts']} fused sorts, no library sort or compaction); every .bloom "
          f"({filter_bytes} B, nh={param.num_hash}) == exact ground truth; the partial .db == "
          f"host pack; machine {machine}", flush=True)

    # 2. The full quota file: each .bloom listed ``copies`` times.
    full = os.path.join(work, "full.db")
    repeated = blooms * copies
    t0 = time.perf_counter()
    build_db_from_bloom_files(full, param, repeated, device=device)
    t_dev = time.perf_counter() - t0
    size = os.path.getsize(full)
    t0 = time.perf_counter()
    host_digest, digest = host_pack_sha256(full, param, repeated)
    t_host = time.perf_counter() - t0
    check(digest == host_digest, "the full .db's sha256 differs from the host pack's")
    print(f"phase 14 pack: {len(repeated)} filters at L={log2_len} -> {size} B .db through "
          f"transpose_chunks_device ({-(-(1 << log2_len) // torch_build_db.DEFAULT_CHUNK_BITS)} "
          f"chunks), sha256 {digest[:16]} == host pack's (chunk by chunk, not written; each "
          f"chunk's crc32 == the file's rows); device pack {t_dev:.2f} s "
          f"({size / t_dev / 1e6:.1f} MB/s), host pack + the file's sha256 beside it "
          f"{t_host:.2f} s ({size / t_host / 1e6:.1f} MB/s)", flush=True)

    # 3. The searches over both files.
    rng = np.random.default_rng(seed + 14)
    seqs = [q for _, q in corpus.queries]
    owners = [corpus.queries[0][0], corpus.queries[-1][0]]
    seqs += [complete_reads(os.path.join(corpus.src, f"{acc}.fasta"), truth[acc][2], 1)[0]
             for acc in owners]
    seqs += [ACGT[rng.integers(0, 4, size=400)].tobytes().decode()
             for _ in range(PROD_RANDOM_QUERIES)]
    files = [full, partial]
    matrix_bytes = ts.chunk_words([open_database(f) for f in files], [0, 1]) * (1 << log2_len) * 4
    check(size > ts.fusion_budget_bytes(), "the full file fits the fusion budget: no slabs")
    outputs, times, calls = {}, [], []
    base = [a for f in files for a in ("-d", f)]
    for threshold, fmt in PROD_CASES:
        got = {}
        for name, extra in (("device", ["--device"]), ("host", [])):
            out = os.path.join(work, f"{name}.out")
            steps = {}
            t0 = time.perf_counter()
            with search_steps(steps) if name == "device" else contextlib.nullcontext():
                rc = torch_kwage_main(base + ["-t", str(threshold), f"--o.{fmt}", "-o", out]
                                      + extra + seqs)
            times.append(f"{name} t={threshold} {fmt} {time.perf_counter() - t0:.2f} s")
            check(rc == 0, f"{name} kwage exited {rc}")
            if name == "device":
                check(steps["route"] == {"gather": 2, "full": 0},
                      f"the device call did not gather both files' rows: {steps}")
                calls.append(f"t={threshold} {fmt}: {fmt_steps(steps)}")
            with open(out) as f:
                got[name] = f.read()
        check(got["device"] == got["host"],
              f"--device output differs from the host engine at -t {threshold} {fmt}")
        outputs[(threshold, fmt)] = got["host"]
    host = {t: search_database_files(files, list(enumerate(seqs)), t) for t, _ in PROD_CASES}
    first = len(corpus.queries)
    for i, acc in enumerate(owners):
        hits = [accession_to_str(m.subject_info.run_accession) for m in host[1.0][first + i]]
        check(hits.count(acc) == copies + 1,
              f"complete read of {acc}: {hits.count(acc)} hits at -t 1.0, {copies + 1} expected")

    def allocated():
        if cuda:
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated(device)
        return 0

    # The full route once (path B): the full file in column slabs.
    threshold, fmt = PROD_CASES[-1]
    out, steps = os.path.join(work, "streamed.out"), {}
    base_mem = allocated()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with search_steps(steps), gather_share(0.0):
        rc = torch_kwage_main(base + ["-t", str(threshold), f"--o.{fmt}", "-o", out, "--device"]
                              + seqs)
    t_streamed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - base_mem if cuda else 0
    check(rc == 0, f"the streamed kwage --device exited {rc}")
    with open(out) as f:
        check(f.read() == outputs[(threshold, fmt)],
              f"the streamed --device output differs from the host engine at -t {threshold} {fmt}")
    check(steps["route"] == {"gather": 0, "full": 2} and steps.get("slabs", 0) >= 2,
          f"the full file did not stream in slabs: {steps}")
    check(peak <= ts.fusion_budget_bytes(),
          f"the streamed call's peak device memory {peak} B passes the budget")
    print(f"phase 14 search: {len(seqs)} queries ({len(corpus.queries)} planted 400 bp, "
          f"{len(owners)} complete reads, {PROD_RANDOM_QUERIES} random) over the full and the "
          f"partial .db (W={-(-len(repeated) // 32)} + {-(-n_acc // 32)}), kwage --device == "
          f"host engine at " + ", ".join(f"-t {t} {f}" for t, f in PROD_CASES) + "; "
          + "; ".join(times) + "; the gather route's calls: " + "; ".join(calls)
          + f"; by the full route at -t {threshold} {fmt} == host engine in {t_streamed:.2f} s: "
          f"the full file in {steps['slabs']} slabs of the {ts.fusion_budget_bytes()} B budget, "
          f"peak device memory {peak} B, " + fmt_steps(steps)
          + f", upload {matrix_bytes / steps['upload_s'] / 1e9:.2f} GB/s", flush=True)

    # The resident searcher, then the mesh on logical shards of the card;
    # each, dropped, frees its device memory at once (no gc.collect()).
    base_mem = allocated()
    t0 = time.perf_counter()
    resident = ResidentSearcher(files, device, budget_bytes=resident_budget)
    t_load = time.perf_counter() - t0
    check(resident.resident_bytes == matrix_bytes,
          f"not all resident: {resident.resident_bytes} of {matrix_bytes} B")
    lat = []
    for threshold, fmt in PROD_CASES:
        for _ in range(2):   # cold, then warm
            t0 = time.perf_counter()
            out = resident.render(seqs, threshold, fmt)
            lat.append(time.perf_counter() - t0)
            check(out == outputs[(threshold, fmt)],
                  f"ResidentSearcher differs from the host engine at -t {threshold} {fmt}")
    held = resident.resident_bytes
    del resident
    check(allocated() == base_mem, "ResidentSearcher kept device memory after del")

    cards = [device] * MESH_SHARDS
    mesh = make_search_mesh(1, MESH_SHARDS, cards)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    mesh_searcher = MeshResidentSearcher(files, mesh, budget_bytes=mesh_budget)
    t_mesh_load = time.perf_counter() - t0
    sdbs = [sdb for sdb, _ in mesh_searcher.groups]
    waves = max(sdb.num_waves for sdb in sdbs)
    check(waves >= 2, f"the mesh ran {waves} wave(s) at {mesh_budget} B a shard")
    streamed = sum(sdb.db is None for sdb in sdbs)
    # A render at -t 0.8 by each route: the streamed group gathers the
    # request's rows, or (GATHER_SHARE 0) re-stages the full file from its
    # pages in every wave; then the count by each route.
    threshold, fmt = PROD_CASES[-1]
    mesh_calls = []
    for name, share in (("gather", ts.GATHER_SHARE), ("full", 0.0)):
        steps = {}
        t0 = time.perf_counter()
        with gather_share(share), mesh_steps(steps):
            out = mesh_searcher.render(seqs, threshold, fmt)
        wall = time.perf_counter() - t0
        check(out == outputs[(threshold, fmt)], f"MeshResidentSearcher by the {name} route "
                                                f"differs from the host engine at -t {threshold} {fmt}")
        check(steps["route"][name] == streamed and steps["route"].get("resident", 0)
              == len(sdbs) - streamed, f"the mesh's {name} render took other routes: {steps}")
        mesh_calls.append(f"by the {name} route {wall:.3f} s ({fmt_steps(steps)})")
    want = [len(host[threshold].get(i, [])) for i in range(len(seqs))]
    for name, share in (("gather", ts.GATHER_SHARE), ("full", 0.0)):
        steps = {}
        t0 = time.perf_counter()
        with gather_share(share):
            got = sum(sdb.total_hits(seqs, threshold, steps) for sdb in sdbs)
        t_total = time.perf_counter() - t0
        check(got.tolist() == want, f"mesh total_hits by the {name} route at -t {threshold} "
                                    f"{got.tolist()} != the hit-list lengths {want}")
        check(steps["route"][name] == streamed,
              f"the mesh's count took other routes than the {name} route: {steps}")
        mesh_calls.append(f"total_hits by the {name} route {t_total:.3f} s "
                          f"({fmt_steps(steps)})")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    check(not cuda or peak <= mesh_budget * MESH_SHARDS + (64 << 20),
          f"mesh peak {peak} B passes {MESH_SHARDS} x {mesh_budget} B")
    del mesh_searcher, sdbs
    check(allocated() == base_mem, "MeshResidentSearcher kept device memory after del")
    print(f"phase 14 serve: ResidentSearcher ({resident_budget} B budget) holds {held} B, "
          f"load {t_load:.2f} s, renders (cold, warm) "
          + ", ".join(f"{x * 1e3:.1f} ms" for x in lat)
          + f" == host engine; MeshResidentSearcher 1 x {MESH_SHARDS} at {mesh_budget} B a "
          f"shard: load {t_mesh_load:.2f} s, {waves} waves, a render at -t {threshold} == "
          f"host engine " + "; ".join(mesh_calls) + ", total_hits == the "
          f"hit-list lengths, peak device memory {peak} B; "
          f"each searcher freed its device memory on del; phase 14 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    n_reads = genome_bp * 4 // scale_corpus.READ_LEN
    return {"num_acc": n_acc, "log2_len": log2_len, "num_hash": param.num_hash,
            "windows": n_acc * n_reads * (scale_corpus.READ_LEN - KMER_LEN + 1),
            "selected": sum(t[2].size for t in truth.values())}


# --- phase 13: the bench programs --------------------------------------------------

def run_bench(device: torch.device, runs=BENCH_RUNS) -> None:
    """Phase 13: each bench program (``python3 -m kwage_tpu_torch.bench.<name>``)
    in a process of its own on the card: it must exit 0, which it does only
    when its own checks pass (the searches == their plain versions and
    every sample under the memory ceiling; every accession built and the
    device filters == exact ground truth; the resident renders == the host
    searcher's; the SriRachA run whole). Every JSON line it prints is
    printed here on a line of its own."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, KWAGE_TORCH_DEVICE=str(device),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t_phase = time.perf_counter()
    for name, argv, extra, timeout in runs:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", f"kwage_tpu_torch.bench.{name}", *argv],
                             cwd=root, env={**env, **extra}, capture_output=True, text=True,
                             timeout=timeout)
        wall = time.perf_counter() - t0
        lines = [line for line in res.stdout.splitlines() if line.startswith("{")]
        check(res.returncode == 0 and lines,
              f"bench.{name} {argv} {extra} exited {res.returncode}: {res.stderr[-3000:]}")
        said = " ".join(argv + [f"{k}={v}" for k, v in extra.items()])
        for line in lines:
            print(f"phase 13 bench {name} {said}: {line}", flush=True)
        print(f"phase 13 bench {name} {said}: exit 0 in {wall:.1f} s", flush=True)
    print(f"phase 13 bench: {len(runs)} runs in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --- phase 15: the JAX package's last programs ----------------------------------------

def program_launches(rec: dict) -> dict:
    """The launches a program's line reports: its own (``launches``) and
    its device children's (``children``, the distributed proof's)."""
    out = collections.Counter(rec.get("launches") or {})
    for child in rec.get("children") or []:
        out.update((child or {}).get("launches") or {})
    return out


def run_tools(device: torch.device, deadline: float, runs=TOOL_RUNS) -> tuple[dict, dict]:
    """Phase 15: each program (``python3 -m kwage_tpu_torch.<module>``) in a
    process of its own on the card; it must exit 0, which it does only when
    its own checks pass (the gather kernels and the searches == their plain
    versions; the ingest images == the host's exact count; the .bloom files
    == exact ground truth; the SriRachA matches == the host engine's; the
    mesh's counts == one device's; no .bloom opened by the dry scheduler;
    every accession terminal and the result sets equal in the distributed
    proof, its device search == the host engine's bytes). Each is allowed
    its seconds, and no more than is left before ``deadline`` (a
    ``time.perf_counter()`` reading). Every JSON line is printed here;
    returns the launches the programs report (each process starts at zero:
    the path's counts) and each program's last JSON object."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, KWAGE_TORCH_DEVICE=str(device),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    launches, last = collections.Counter(), {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_tools_") as out_dir:
        for module, extra, timeout in runs:
            name = module.split(".")[1]
            t0 = time.perf_counter()
            timeout = max(1.0, min(timeout, deadline - t0))
            try:
                res = subprocess.run(
                    [sys.executable, "-m", f"kwage_tpu_torch.{module}", "--out",
                     os.path.join(out_dir, f"{name}.json")],
                    cwd=root, env={**env, **extra}, capture_output=True, text=True,
                    timeout=timeout)
            except subprocess.TimeoutExpired as e:
                said = [(x or b"")[-3000:].decode(errors="replace") for x in (e.stdout, e.stderr)]
                check(False, f"{module} {extra} ran past {timeout:.0f} s; its output: {said[0]}"
                             f"; its errors: {said[1]}")
            wall = time.perf_counter() - t0
            lines = [line for line in res.stdout.splitlines() if line.startswith("{")]
            check(res.returncode == 0 and lines,
                  f"{module} {extra} exited {res.returncode}: {res.stderr[-3000:]}")
            said = " ".join(f"{k}={v}" for k, v in extra.items())
            for line in lines:
                print(f"phase 15 tools {name} {said}: {line}", flush=True)
                last[module] = json.loads(line)
                launches.update(program_launches(last[module]))
            print(f"phase 15 tools {name} {said}: exit 0 in {wall:.1f} s", flush=True)
    cuts = "; ".join(f"{module} {k}={v}" for module, extra, _ in runs for k, v in extra.items())
    print(f"phase 15 tools: {len(runs)} programs in {time.perf_counter() - t_phase:.1f} s"
          + (f" (cut: {cuts})" if cuts else ""), flush=True)
    return dict(launches), last


# The chunked layout's edges: (tag, R, W, nq, nk, nh, valid positions a
# query or None for all but every third, byte offset of db).
VARIANT_SHAPES = [
    ("W=131 shard", 4096, 131, 3, 77, 3, [77, 40, 0], 0),
    ("nh=1, nk=33", 2048, 64, 2, 33, 1, [33, 1], 0),
    ("nh=9 (at run time)", 2048, 64, 2, 100, 9, None, 0),
    ("W=3, nk=1", 512, 3, 4, 1, NUM_HASH, [1, 0, 1, 1], 0),
    ("db 4 bytes off 16", 1024, 512, 2, 64, NUM_HASH, None, 4),
]


def variant_checks(device: torch.device, seed: int, phases: dict) -> dict:
    """gather1 and gather5_and (csrc/variants/search_phases.cu) against
    their plain versions, bit for bit, at the chunked layout's edges (a W
    with no multiple of 4: the 4-byte path; nk past a 32-k-mer chunk; nh = 1
    and nh = 9, the run-time path; a query with no valid k-mer; valid flags
    with holes; a db 4 bytes off a 16-byte boundary). The main shape's
    check, time and plain time are ``bench.search_phases``' own from this
    run's phase 15 (``phases``, its last line: 2^22 x 512, 8 x 1024 valid
    k-mers, nh = 5, the kernels timed by CUDA-graph replays cycling 8 index
    sets). Bound: bytes, the rows the valid k-mers gather (seed 0 alone for
    gather1), idx, valid and the output word; operations, one XOR (or AND)
    a gathered word."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = phases["shape"]
    results = {}
    for name in search_phases.ENTRIES:
        r = phases["phases"][name]
        results[name] = {"max_abs_err": r["max_abs_err"], "ms": r["ms_per_iter"],
                         "plain_ms": r["plain_ms"], "library_ms": None,
                         "shape": "R=2^{log2_rows} W={w} nq={nq} nk={nk} nh={seeds}".format(
                             w=shape["row_bytes"] // 4, **shape),
                         **bound(r["bytes"], r["operations"])}
    for tag, R, W, nq, nk, nh, n_valid, offset in VARIANT_SHAPES:
        base = random_words((R * W + offset // 4,), gen, device)
        db = base[offset // 4:].view(R, W)
        idx = torch.randint(0, R, (nq, nk, nh), dtype=torch.int32, device=device, generator=gen)
        idx[0, 0, 0] = R - 1
        if n_valid is None:
            valid = torch.ones((nq, nk), dtype=torch.bool, device=device)
            valid[:, 1::3] = False
        else:
            valid = torch.zeros((nq, nk), dtype=torch.bool, device=device)
            for q, n in enumerate(n_valid):
                valid[q, :n] = True
            valid[0, 5::7] = False
        for name, fn, ref in (("gather1", search_phases.gather1, search_phases.gather1_ref),
                              ("gather5_and", search_phases.gather5_and,
                               search_phases.gather5_and_ref)):
            err = max_abs_err(fn(db, idx, valid), ref(db, idx, valid))
            check(err == 0, f"{name} differs from its plain version at {tag}")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    print("phase 15 variants: gather1 and gather5_and == their plain versions at "
          + ", ".join(t[0] for t in VARIANT_SHAPES) + "; main (bench.search_phases): " + "; ".join(
              f"{k} {r['ms']:.4f} ms graph of a {r['bound_ms']:.4f} ms bound ({r['bound_by']}), "
              f"plain {r['plain_ms']:.3f} ms" for k, r in results.items()), flush=True)
    return results


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


GRAPH_LAUNCHES = 20


def graph_ms(launch, reps: int) -> float:
    """Mean ms of one ``launch(stream)`` over ``reps`` replays of a CUDA
    graph of GRAPH_LAUNCHES of them: the host's cost of a ctypes launch
    (5-6 us) is not in it, where ``cuda_ms``'s launches in a row carry it."""
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(GRAPH_LAUNCHES):
            launch(side.cuda_stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * GRAPH_LAUNCHES)


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the memory rate,
    or its integer operations over the int32 rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(nbytes), "operations": int(nops)}


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


def search_chunk() -> int:
    """k-mer positions a block of csrc/search.cu's searches takes (kWarps x
    kKmersPerWarp)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), SOURCES["search_counts"])
    with open(path) as f:
        c = dict(re.findall(r"constexpr int (k\w+) = (\d+);", f.read()))
    return int(c["kWarps"]) * int(c["kKmersPerWarp"])


def search_own_traffic(name: str, valid: torch.Tensor, W: int) -> int:
    """Bytes of the chunked kernels' own traffic beyond the function's: the
    entry sets the output (search_complete: to all-ones, W words a query;
    the counts, or total_hits' scratch: to 0, W*32 a query), every chunk
    with a valid k-mer merges at most that many words into it with
    atomics, and total_hits' compare kernel reads the counts back. In L2 at
    these sizes; the bound never includes it."""
    nq, nk = valid.shape
    chunk = search_chunk()
    padded = torch.nn.functional.pad(valid, (0, (-nk) % chunk))
    busy = int(padded.view(nq, -1, chunk).any(dim=2).sum()) if nk else 0
    words = W if name == "search_complete" else W * 32
    return (nq + busy + (nq if name == "search_total_hits" else 0)) * words * 4


def search_launcher(name, db, idx, valid, out, tcount=None):
    """``launch(stream)`` of search kernel ``name`` on these tensors; the
    total_hits entry gets a scratch of its own (zeroed by the entry)."""
    W, (nq, nk, nh) = db.shape[1], idx.shape
    held = [db, idx, valid, out]
    if tcount is not None:
        held[3:] = [tcount, out, torch.empty(kernels.scratch_words("search", nq, W),
                                             dtype=torch.int32, device=db.device)]
    ptrs = [t.data_ptr() for t in held]
    return lambda stream, held=held: kernels.launch(name, *ptrs, nq, nk, nh, W, stream)


def search_row(name, tag, launch, ref, n_valid, W, nbytes, nops, own, results, lines) -> None:
    """Time one search kernel two ways, a CUDA graph's replays (the
    kernels line's reading) and launches in a row (the host's launch cost
    in it); print both; a kernel's first row is its result."""
    ms = graph_ms(launch, 10)
    launch_ms = cuda_ms(lambda: launch(torch.cuda.current_stream().cuda_stream), 20)
    plain = cuda_ms(ref, 5)
    gathered = sum(n_valid) * NUM_HASH * W * 4
    lines.append(f"{name} {tag}: kernel {ms:.4f} ms graph / {launch_ms:.4f} ms launches "
                 f"({gathered / ms / 1e6:.1f} GB/s gathered) plain {plain:.3f} ms")
    if name not in results:
        results[name] = {"max_abs_err": 0, "ms": ms, "plain_ms": plain, "launch_ms": launch_ms,
                         "shape": f"{tag}, nh={NUM_HASH}, {sum(n_valid)} valid k-mers",
                         "own_traffic_ms": own / HBM_BYTES_PER_S * 1e3, **bound(nbytes, nops)}


# (tag, R, W, valid k-mers a query): the bench's fused shape, then R*W = 2^32.
SEARCH_SHAPES = [("main", 1 << LOG2_FILTER_LEN, 512, [1, 3, 1024, 1000, 777, 512, 129, 0]),
                 ("R=2^26", 1 << 26, 64, [1, 2, 256, 200])]


def search_checks(device, gen, results: dict, lines: list, shapes=SEARCH_SHAPES) -> None:
    """The three searches against their plain versions: at the bench's
    fused shape (the kernels line's rows; W=512, 8 queries of 1024
    positions, 3446 valid k-mers), on a mesh column shard whose width is no
    multiple of 4 (W=131: search_counts' and search_total_hits' 4-byte
    path), and at R*W = 2^32 words (int64 offsets), each timed. Then the
    chunked kernels' edges (search_edge_checks). The thresholds of
    search_total_hits sit at each query's mean count (a k-mer's seed-AND
    keeps a bit with probability 2^-nh), so about half the columns pass."""
    def compare(name, got, want, tag):
        err = max_abs_err(got, want)
        check(err == 0, f"{name} differs from its plain version at {tag} (max err {err})")
        if name in results:
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    for tag, R, W, n_valid in shapes:
        nq, nk = len(n_valid), max(n_valid)
        db, idx, valid = search_inputs(R, W, nq, nk, n_valid, gen, device)
        tc = torch.tensor([max(1, n >> NUM_HASH) for n in n_valid], dtype=torch.int32,
                          device=device)
        views = [(tag, db)] + ([("W=131", db[:, :131].contiguous())] if tag == "main" else [])
        for vtag, shard in views:
            Wv = shard.shape[1]
            label = f"{vtag} R={R} W={Wv} nq={nq} nk={nk}"
            gathered = sum(n_valid) * NUM_HASH * Wv * 4
            for name, fn, ref in (("search_complete", ts.search_complete, ts.complete_ref),
                                  ("search_counts", ts.search_counts, ts.counts_ref),
                                  ("search_total_hits", ts.search_total_hits,
                                   ts.total_hits_ref)):
                extra = (tc,) if name == "search_total_hits" else ()
                got, want = fn(shard, idx, valid, *extra), ref(shard, idx, valid, *extra)
                compare(name, got, want, label)
                if name == "search_total_hits":
                    check(0 < int(got.sum()) < nq * Wv * 32,
                          f"search_total_hits {label}: all or no column")
                    out = torch.zeros_like(got)
                else:
                    out = torch.empty_like(got)
                # Bytes: the rows this run's valid k-mers gather (each once),
                # the indices, the flags (and thresholds) and the output.
                # Operations: one AND a gathered word; for the counts about 5
                # more a k-mer and word to add it into carry-save planes;
                # total_hits also a compare a column.
                per_word = NUM_HASH + (0 if name == "search_complete" else 5)
                nops = sum(n_valid) * Wv * per_word + (
                    nq * Wv * 32 if name == "search_total_hits" else 0)
                own = search_own_traffic(name, valid, Wv)
                search_row(name, label, search_launcher(name, shard, idx, valid, out, *extra),
                           lambda: ref(shard, idx, valid, *extra), n_valid, Wv,
                           gathered + nbytes_of(idx, valid, got, *extra), nops, own,
                           results, lines)
            del shard
        if tag == "main":
            complete_dense_checks(db, idx, valid, gen, compare, lines)
        del db, idx, valid
        torch.cuda.empty_cache()
    search_edge_checks(device, gen, compare, lines)


def dense_rows(rows: torch.Tensor, gen) -> torch.Tensor:
    """Rows whose complete match is not trivial: word columns w % 4 == 0
    all-ones, w % 4 == 1 random at 1 - 2^-5 fill, w % 4 >= 2 the same OR
    a fixed mask that no AND clears (0x01010101 << (w % 7))."""
    fill = random_words(rows.shape, gen, rows.device)
    for _ in range(4):
        fill |= random_words(rows.shape, gen, rows.device)
    col = torch.arange(rows.shape[1], device=rows.device)
    fixed = (0x01010101 * torch.pow(2, col % 7)).to(torch.int32)
    return torch.where(col % 4 == 0, -1, torch.where(col % 4 == 1, fill, fill | fixed))


def complete_dense_checks(db, idx, valid, gen, compare, lines: list) -> None:
    """search_complete where its answer is not trivial: on random rows at
    ~50% fill the AND of more than a few k-mers is 0 in every word, so a
    kernel that wrote zeros would pass. Every row the queries gather is
    made dense (dense_rows; db is changed in place), so each tile holds
    words that stay all-ones, words that go to 0 for the long queries and
    words between; every query with a valid k-mer must have a word that is
    neither 0 nor all-ones in the plain version's answer, and the kernel
    must equal it, at the main shape and on the W=131 shard."""
    rows = torch.unique(idx[valid].long())
    db[rows] = dense_rows(db[rows], gen)
    nq, nk = valid.shape
    for shard in (db, db[:, :131].contiguous()):
        W = shard.shape[1]
        got, want = ts.search_complete(shard, idx, valid), ts.complete_ref(shard, idx, valid)
        label = f"dense rows R={shard.shape[0]} W={W} nq={nq} nk={nk}"
        compare("search_complete", got, want, label)
        between = ((want != 0) & (want != -1)).any(dim=1)
        check(bool((between == valid.any(dim=1)).all()),
              f"search_complete {label}: a query with valid k-mers has only 0 and all-ones words")
        check(bool((want[~valid.any(dim=1)] == -1).all()), f"{label}: a query with none")
        out = torch.empty_like(got)
        ms = graph_ms(search_launcher("search_complete", shard, idx, valid, out), 10)
        lines.append(f"search_complete {label}: kernel {ms:.4f} ms graph, == plain; words "
                     f"all-ones {int((want == -1).sum())}, 0 {int((want == 0).sum())}, "
                     f"between {int(((want != 0) & (want != -1)).sum())} of {want.numel()}")


def search_edge_checks(device, gen, compare, lines: list) -> None:
    """search_counts and search_total_hits (and search_complete) against
    their plain versions where the chunked kernels have edges: nk around
    and between chunks (0, 1, chunk - 1, chunk, chunk + 1, 45, 200),
    flags with holes (a random 70%) and as prefixes, a query with no valid
    k-mer, widths on both load paths (W % 4 == 0 and not: 1, 3, 4, 131,
    512) and a db that starts 4 bytes past a 16-byte boundary."""
    chunk = search_chunk()
    R, nq = 1 << 14, 5
    base = random_words((R * 512 + 1,), gen, device)
    n = 0
    for W in (1, 3, 4, 131, 512):
        for nk in (0, 1, chunk - 1, chunk, chunk + 1, 45, 200):
            for holes in (False, True):
                idx = torch.randint(0, R, (nq, nk, NUM_HASH), dtype=torch.int32, device=device,
                                    generator=gen)
                if holes:
                    valid = torch.rand((nq, nk), device=device, generator=gen) < 0.7
                else:
                    valid = torch.zeros((nq, nk), dtype=torch.bool, device=device)
                    for q, m in enumerate((nk, 0, 1, (nk + 1) // 2, nk - 1)):
                        valid[q, :max(m, 0)] = True
                valid[1] = False
                tc = torch.tensor([1, 1, 2, max(1, nk // 20), max(1, nk // 40)],
                                  dtype=torch.int32, device=device)
                for offset in (0, 1) if W % 4 == 0 else (0,):
                    db = base[offset:offset + R * W].view(R, W)
                    label = f"R={R} W={W} nk={nk} holes={holes} offset={offset * 4} B"
                    compare("search_counts", ts.search_counts(db, idx, valid),
                            ts.counts_ref(db, idx, valid), label)
                    compare("search_total_hits", ts.search_total_hits(db, idx, valid, tc),
                            ts.total_hits_ref(db, idx, valid, tc), label)
                    compare("search_complete", ts.search_complete(db, idx, valid),
                            ts.complete_ref(db, idx, valid), label)
                    n += 1
    lines.append(f"search_counts, search_total_hits, search_complete at {n} edge shapes "
                 f"(W = 1, 3, 4, 131, 512; nk = 0, 1, {chunk - 1}, {chunk}, {chunk + 1}, 45, "
                 "200; flags with holes and prefixes, a query with none; db 4 B off a "
                 "16-byte boundary) == plain")


SORT_TILE = tcount.SORT_TILE   # pairs a block of csrc/sort.cu takes a pass
# Operations a pair and pass of THIS radix sort, an estimate: the digit (5),
# the match, its leader and the warp's counter (6), the rank, the staging
# and the address (9). The design's own count, reported beside the passes'
# traffic and no part of the function's bound.
SORT_OPS_PER_PASS = 20


def sort_pairs(n: int, k: int, num_acc: int, gen, device, invalid: int = 1,
               by_word: bool = False):
    """int64 (acc, word) windows as the ingest makes them: words of k bases
    drawn from a pool (about 8 windows a word; k = 32: any int64),
    accessions in [0, num_acc], num_acc being the invalid windows'
    (``invalid`` shares of num_acc + invalid). ``by_word``: a word keeps to
    one accession, so its windows form one run (the ingest's case: this is
    what select_runs and bloom_set_bits then see)."""
    distinct = max(n // 8, 1)
    if k == 32:
        pool = torch.empty(distinct, dtype=torch.int64, device=device).random_(
            -2**63, 2**63 - 1, generator=gen)
    else:
        pool = torch.randint(0, 1 << (2 * k), (distinct,), device=device, generator=gen)
    pick = torch.randint(0, distinct, (n,), device=device, generator=gen)
    acc = (pick % (num_acc + invalid) if by_word else
           torch.randint(0, num_acc + invalid, (n,), device=device, generator=gen))
    return acc.clamp_(max=num_acc), pool[pick]


def sort_traffic(n: int, kept: int, plan, acc_bytes: int) -> int:
    """Bytes THIS radix sort moves: the histogram reads the accessions and
    the kept words; the first pass reads them again and writes the kept
    pairs narrow (8 + acc_bytes), the middle passes read and write them
    narrow, the last reads them narrow and writes int64 pairs."""
    narrow = kept * (8 + acc_bytes)
    first_read = n * 8 + kept * 8
    passes = len(plan)
    if passes == 1:
        return 2 * first_read + kept * 16
    return 2 * first_read + narrow + 2 * narrow * (passes - 2) + narrow + kept * 16


def sort_checks(device: torch.device, gen, ingest: dict, record,
                lines: list, results: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """radix_sort_pairs against its plain versions, bit for bit, timed beside
    two library yardsticks: compaction + ``torch.sort`` twice over the valid
    pairs (sort_valid_windows' function) and ``torch.sort`` twice over all
    pairs (sort_windows'). Rows: the ingest's fused batch, valid only (the
    main path's call: the kernels line's row); the same window count with a
    30% invalid share drawn at random (all pairs, and valid only); 2^24
    windows of one accession (a chunk call), valid only. Then k = 15, 16,
    32, 1 and 300 accessions, every byte of both keys (no widths given), n
    around the tile's edges, all-equal and already sorted input, each
    through both entries. Returns the sorted pairs for the kernels after
    it: the fused batch's valid windows (what the main path hands them)
    and the 30%-invalid row's all pairs, by tag."""
    def compare(acc, words, k, num_acc):
        got = tcount.sort_windows(acc, words, k, num_acc)
        want = tcount.sort_windows_ref(acc, words)
        err = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        v_got = None
        if num_acc is not None and num_acc > 0:
            v_got = tcount.sort_valid_windows(acc, words, k, num_acc)
            v_want = tcount.sort_valid_windows_ref(acc, words, num_acc)
            check(v_got[0].shape == v_want[0].shape, "sort_valid_windows: wrong length")
            err += int((v_got[0] != v_want[0]).sum()) + int((v_got[1] != v_want[1]).sum())
        return got, v_got, err

    def timed(fn):
        """ms of fn and the peak device memory while it runs (the inputs
        and the row's sorted pairs held)."""
        torch.cuda.reset_peak_memory_stats(device)
        ms = cuda_ms(fn, 3)
        return ms, torch.cuda.max_memory_allocated(device)

    k, outputs = INGEST_K, {}
    n_main = ingest["rows"] * (ingest["blen"] - k + 1)
    for tag in ("the fused batch", "30% invalid", "a chunk call"):
        if tag == "the fused batch":
            num_acc = ingest["num_acc"]
            acc, words = fused_batch_pairs(ingest["rows"], ingest["blen"] - k + 1,
                                           ingest["live_rows"], ingest["valid_per_row"],
                                           num_acc, gen, device, k)
        elif tag == "30% invalid":
            num_acc = ingest["num_acc"]
            acc, words = sort_pairs(n_main, k, num_acc, gen, device, invalid=6, by_word=True)
        else:
            num_acc = 1
            acc, words = sort_pairs(1 << 24, k, 1, gen, device, invalid=1, by_word=True)
        n = acc.shape[0]
        got, v_got, err = compare(acc, words, k, num_acc)
        kept = int(((acc >= 0) & (acc < num_acc)).sum())
        valid_ms, valid_peak = timed(lambda: tcount.sort_valid_windows(acc, words, k, num_acc))
        lib_valid, lib_valid_peak = timed(
            lambda: tcount.sort_valid_windows_ref(acc, words, num_acc))
        lib_all, lib_all_peak = timed(lambda: tcount.sort_windows_ref(acc, words))
        plan = tcount.sort_plan(k, (num_acc - 1).bit_length())
        acc_bytes = tcount.sort_acc_bytes((num_acc - 1).bit_length())
        pass_ms = sort_traffic(n, kept, plan, acc_bytes) / HBM_BYTES_PER_S * 1e3
        pass_ops_ms = (n + len(plan) * kept * SORT_OPS_PER_PASS) / INT32_OPS_PER_S * 1e3
        note = ""
        if tag == "the fused batch":
            # The same two launches with the kept count known and the buffers
            # made beforehand: the difference is what the wrapper's copy of
            # the kept count to the host (and its allocations) costs.
            case = sort_case(tag, acc, words, num_acc, True)
            lib = kernels.get_lib()
            launches_ms = cuda_ms(lambda: check(
                case.call(lib, torch.cuda.current_stream(device).cuda_stream) == 0,
                "radix_sort_pairs launch failed"), 3)
            del case
            note = (f"; the two launches alone {launches_ms:.4f} ms, so the count's copy to "
                    f"the host and the allocations {valid_ms - launches_ms:.4f} ms")
        if tag == "30% invalid":
            all_ms, all_peak = timed(lambda: tcount.sort_windows(acc, words, k, num_acc))
            note = (f"; all pairs: kernel {all_ms:.4f} ms, peak {all_peak / 1e9:.2f} GB, "
                    f"torch.sort twice {lib_all:.3f} ms, peak {lib_all_peak / 1e9:.2f} GB")
        # The function's bound -- bytes: every accession read once, the kept
        # words read once, the kept pairs written once; operations: the
        # accession's test and each of a kept pair's 16 key bytes looked at
        # once. This design's own traffic and operations stand beside it.
        record("radix_sort_pairs",
               f"{tag} n={n} kept={kept} k={k} num_acc={num_acc}, valid only, {len(plan)} passes",
               err, valid_ms, lib_valid,
               f" ({kept / valid_ms / 1e6:.2f} G kept pairs/s; the passes' traffic alone "
               f"{pass_ms:.3f} ms, their operations {pass_ops_ms:.3f} ms; peak "
               f"{valid_peak / 1e9:.2f} GB; compaction + torch.sort twice {lib_valid:.3f} ms, "
               f"peak {lib_valid_peak / 1e9:.2f} GB; torch.sort twice over all pairs "
               f"{lib_all:.3f} ms{note})",
               n * 8 + kept * 24, n + kept * 16)
        if tag == "the fused batch":
            results["radix_sort_pairs"].update(
                library_ms=lib_valid, library_all_pairs_ms=lib_all, lsd_pass_traffic_ms=pass_ms,
                lsd_pass_operations_ms=pass_ops_ms, peak_bytes=valid_peak,
                sync_ms=valid_ms - launches_ms)
            outputs[tag] = v_got
        if tag == "30% invalid":
            outputs[tag] = got
        del acc, words, got, v_got
        torch.cuda.empty_cache()
    n_cmp = 0
    sizes = [2, 3, 31, 32, 33, 255, 257, SORT_TILE - 1, SORT_TILE, SORT_TILE + 1,
             2 * SORT_TILE - 1, 3 * SORT_TILE + 5, 1 << 20]
    for k, num_acc in ((15, 1), (16, 300), (31, 14), (32, 3), (32, 300), (None, None)):
        for n in sizes:
            acc, words = sort_pairs(n, k or 32, num_acc if num_acc is not None else 1 << 40,
                                    gen, device)
            if num_acc is None:
                acc -= 1 << 39            # negative accessions: the sign digit of both keys
            _, _, err = compare(acc, words, k, num_acc)
            record("radix_sort_pairs", f"n={n} k={k} num_acc={num_acc}", err, log=False)
            n_cmp += 1
    acc, words = sort_pairs(1 << 20, INGEST_K, 14, gen, device)
    for tag, a, w in (("all equal", torch.zeros_like(acc), torch.full_like(words, 5)),
                      ("sorted", *tcount.sort_windows_ref(acc, words)),
                      ("one accession digit only", acc, torch.zeros_like(words))):
        _, _, err = compare(a, w, INGEST_K, 14)
        record("radix_sort_pairs", tag, err, log=False)
        n_cmp += 1
    lines.append(f"radix_sort_pairs ({n_cmp} inputs, sort_windows and sort_valid_windows each: "
                 "n = 2 .. 3 tiles + 5 and 2^20 at k = 15, 16, 31, 32 and all 16 bytes, "
                 "num_acc 1, 3, 14, 300; all equal; sorted; one digit) == plain")
    return outputs


def word_pool(distinct: int, k: int, gen, device) -> torch.Tensor:
    """``distinct`` random int64 k-mer words (k = 32: any int64, half with
    the top bit set)."""
    if k == 32:
        pool = torch.empty(max(distinct, 1), dtype=torch.int64, device=device).random_(
            -2**63, 2**63 - 1, generator=gen)
    else:
        pool = torch.randint(0, 1 << (2 * k), (max(distinct, 1),), device=device, generator=gen)
    return pool


def sorted_words(n: int, distinct: int, k: int, gen, device, pool=None) -> torch.Tensor:
    """n int64 k-mer words drawn from ``pool``, or from a new pool of
    ``distinct``, sorted as signed values."""
    pool = word_pool(distinct, k, gen, device) if pool is None else pool
    pick = torch.randint(0, pool.shape[0], (n,), device=device, generator=gen)
    return torch.sort(pool[pick]).values


def distinct_run(n: int, pool: torch.Tensor, cap: int, gen, device):
    """A sorted run of distinct (word, count) pairs, as run_counts leaves a
    chunk's: the runs of n words drawn from ``pool``."""
    words, counts, stats, _ = tcount.run_counts_ref(sorted_words(n, 0, 0, gen, device, pool),
                                                    None, cap)
    num = int(stats[0])
    return words[:num], counts[:num]


def counts_err(got, want) -> int:
    """Entries that differ between two run_counts results: the stats, then
    the words, counts and flags up to num."""
    err = int((got[2] != want[2]).sum())
    if err:
        return err
    num = int(want[2][0])
    err = int((got[0][:num] != want[0][:num]).sum()) + int((got[1][:num] != want[1][:num]).sum())
    if (got[3] is None) != (want[3] is None):
        return err + 1
    return err + (0 if want[3] is None else int((got[3][:num] != want[3][:num]).sum()))


def merge_checks(device: torch.device, gen, record, lines: list, results: dict,
                 chunked: dict) -> None:
    """run_counts and merge_counts against their plain versions, bit for bit.
    Timed: a 46 Mbp accession's sorted valid windows (``chunked``: phase 12's
    count; one chunk from the card, run_counts with the threshold, the main
    path's call), beside torch.unique_consecutive(return_counts=True), which
    computes run_counts' function; then the last merge of its CHUNK_BP chunks
    (the runs of all but the last chunk's windows with the last chunk's, the
    threshold too; no PyTorch call merges counted runs). Then a real
    accession's shape: run_counts over a chunk of CHUNK_WINDOWS_MAX windows,
    merge_counts of an accumulator of 2^28 words with a chunk's 2^26. Then
    the tile edges (RUN_TILE positions), k = 32 signed words, weights that
    saturate, inputs off a 16-byte boundary, and empty, disjoint, identical,
    interleaved runs and runs with an equal pair at every tile edge."""
    k, cap = INGEST_K, MIN_COUNT

    def timed_run_counts(tag, words, reps):
        """run_counts with the threshold (the main path's call) against
        its plain version and timed, beside torch.unique_consecutive.
        Bytes: the words in, the distinct words, counts and flags out;
        operations: about 4 a position (the compare, the flag, the scan)."""
        n = words.shape[0]
        want = tcount.run_counts_ref(words, None, cap, cap)
        err, num = counts_err(tcount.run_counts(words, None, cap, cap), want), int(want[2][0])
        del want
        ms = cuda_ms(lambda: tcount.run_counts(words, None, cap, cap), reps)
        plain = cuda_ms(lambda: tcount.run_counts_ref(words, None, cap, cap), 3)
        library = cuda_ms(lambda: torch.unique_consecutive(words, return_counts=True), 3)
        by = bound(n * 8 + num * 13, 4 * n)
        record("run_counts", f"{tag} n={n} distinct={num} cap=min_count={cap}", err, ms, plain,
               f" ({n / ms / 1e6:.1f} G positions/s, {by['bound_ms'] / ms:.3f} of its "
               f"{by['bound_ms']:.4f} ms bound; torch.unique_consecutive {library:.4f} ms)",
               by["bytes"], by["operations"])
        return library

    def timed_merge(tag, wa, ca, wb, cb, reps):
        """merge_counts with the threshold against its plain version and
        timed (no PyTorch call merges counted runs). Bytes: both runs in,
        the merged distinct words, counts and flags out; operations: about
        8 a pair."""
        na, nb = wa.shape[0], wb.shape[0]
        want = tcount.merge_counts_ref(wa, ca, wb, cb, cap, cap)
        err = counts_err(tcount.merge_counts(wa, ca, wb, cb, cap, cap), want)
        num = int(want[2][0])
        del want
        ms = cuda_ms(lambda: tcount.merge_counts(wa, ca, wb, cb, cap, cap), reps)
        plain = cuda_ms(lambda: tcount.merge_counts_ref(wa, ca, wb, cb, cap, cap), 1)
        by = bound((na + nb) * 12 + num * 13, 8 * (na + nb))
        record("merge_counts", f"{tag} na={na} nb={nb} distinct={num} cap=min_count={cap}", err,
               ms, plain, f" ({(na + nb) / ms / 1e6:.1f} G pairs/s, {by['bound_ms'] / ms:.3f} "
               f"of its {by['bound_ms']:.4f} ms bound)", by["bytes"], by["operations"])

    n, distinct, chunks = chunked["windows"], chunked["distinct"], chunked["chunks"]
    results["run_counts"]["library_ms"] = timed_run_counts(
        "a 46 Mbp accession's valid windows", sorted_words(n, distinct, k, gen, device), 10)
    last = n // chunks
    pool = word_pool(distinct, k, gen, device)
    wa, ca = distinct_run(n - last, pool, cap, gen, device)
    wb, cb = distinct_run(last, pool, cap, gen, device)
    del pool
    timed_merge(f"the last of {chunks} chunks' merges", wa, ca, wb, cb, 10)
    del wa, ca, wb, cb
    torch.cuda.empty_cache()

    # A real accession's shape: a chunk of CHUNK_WINDOWS_MAX sorted windows,
    # about half distinct; an accumulator of 2^28 distinct words merged with
    # a chunk's 2^26, half of them in the accumulator.
    n = torch_make_bloom.CHUNK_WINDOWS_MAX
    timed_run_counts("a chunk at CHUNK_WINDOWS_MAX", sorted_words(n, n * 7 // 10, k, gen, device),
                     5)
    torch.cuda.empty_cache()
    acc = 2 * n                      # 2^28 distinct words, sorted: running sums of gaps
    wa = torch.cumsum(torch.randint(1, (1 << (2 * k)) // acc, (acc,), device=device,
                                    generator=gen), 0)
    wb = torch.unique(torch.cat([
        wa[torch.randint(0, acc, (n // 4,), device=device, generator=gen)],
        word_pool(n // 4, k, gen, device)]))
    ca = torch.randint(1, cap + 1, wa.shape, dtype=torch.int32, device=device, generator=gen)
    cb = torch.randint(1, cap + 1, wb.shape, dtype=torch.int32, device=device, generator=gen)
    timed_merge("an accumulator of 2^28 words and a chunk's", wa, ca, wb, cb, 5)
    del wa, ca, wb, cb
    torch.cuda.empty_cache()

    n_cmp = 0

    def run_case(tag, words, weights=None, cap=tcount.COUNT_CAP, min_count=0):
        nonlocal n_cmp
        err = counts_err(tcount.run_counts(words, weights, cap, min_count),
                         tcount.run_counts_ref(words, weights, cap, min_count))
        record("run_counts", tag, err, log=False)
        n_cmp += 1

    tile = tcount.RUN_TILE
    sizes = [0, 1, 2, tile - 1, tile, tile + 1, 3 * tile + 5, 1 << 20]
    for kk in (31, 32):
        for i, m in enumerate(sizes):
            run_case(f"n={m} k={kk}", sorted_words(m, max(m // 3, 1), kk, gen, device),
                     cap=(tcount.COUNT_CAP, 1, 5)[i % 3], min_count=(0, 1, 5)[i % 3])
    ar = lambda m: torch.arange(m, dtype=torch.int64, device=device)  # noqa: E731
    for length in (tile - 1, tile, tile + 1, 5000):
        run_case(f"runs of {length}", torch.repeat_interleave(ar(600), length)[: 1 << 20] * 7 - 9,
                 cap=5, min_count=5)
    words = sorted_words(3 * tile + 7, tile, 31, gen, device)
    for off in (1, 2, 3):            # 8, 16, 24 bytes in: inputs and outputs off 16 bytes
        run_case(f"a misaligned head, {off} words in", words[off:], cap=5, min_count=5)
        w = torch.randint(1, 3, (words.shape[0] + off,), dtype=torch.int32, device=device,
                          generator=gen)[off:]
        run_case(f"misaligned weights, {off} in", words[: w.shape[0]], w, 5, 5)
    lengths = torch.randint(1, 100, (3000,), device=device, generator=gen)
    run_case("runs of 1-99, cap 40", torch.repeat_interleave(ar(3000), lengths), cap=40,
             min_count=40)
    run_case("one run over a stage and the ring's end (4 tiles)",
             torch.full((4 * tile + 3,), 11, dtype=torch.int64, device=device))
    run_case("one run of 2^20", torch.full((1 << 20,), -3, dtype=torch.int64, device=device))
    run_case("one run of 2^20, cap 5", torch.full((1 << 20,), 3, dtype=torch.int64,
                                                  device=device), cap=5, min_count=5)
    run_case("all distinct", ar((1 << 20) + 3) - (1 << 19))
    run_case("a run of 5000 from 2040", torch.cat([ar(2040), torch.full((5000,), 2040,
                                                   dtype=torch.int64, device=device),
                                                   ar(3000) + 2041]), cap=5, min_count=5)
    words = sorted_words(1 << 20, 1 << 16, 32, gen, device)
    for hi, cap_, m in ((1 << 30, tcount.COUNT_CAP, 0), (3, 5, 5), (1 << 30, tcount.COUNT_CAP,
                                                                   tcount.COUNT_CAP)):
        w = torch.randint(1, hi + 1, words.shape, dtype=torch.int32, device=device, generator=gen)
        run_case(f"weights 1..{hi} cap {cap_} min_count {m}", words, w, cap_, m)

    def merge_case(tag, wa, wb, cap=5, min_count=5):
        nonlocal n_cmp
        ca = torch.randint(1, cap + 1, wa.shape, dtype=torch.int32, device=device, generator=gen)
        cb = torch.randint(1, cap + 1, wb.shape, dtype=torch.int32, device=device, generator=gen)
        for m in (0, min_count):
            err = counts_err(tcount.merge_counts(wa, ca, wb, cb, cap, m),
                             tcount.merge_counts_ref(wa, ca, wb, cb, cap, m))
            record("merge_counts", f"{tag} min_count={m}", err, log=False)
            n_cmp += 1

    empty = ar(0)
    for m in (1023, 1024, 3000, 1 << 20):
        run = ar(m) * 2 - m
        merge_case(f"empty A, nb={m}", empty, run)
        merge_case(f"na={m}, empty B", run, empty)
        merge_case(f"disjoint, A below, n={m}", run, run + 4 * m)
        merge_case(f"disjoint, B below, n={m}", run + 4 * m, run)
        merge_case(f"interleaved, n={m}", run, run + 1)
        merge_case(f"identical, n={m}", run, run.clone(), tcount.COUNT_CAP, 3)
        merge_case(f"shifted by one (pairs across tile edges), n={m}", run, run + 2)
    merge_case("both empty", empty, empty)
    for m in (tile, 3 * tile + 5, 1 << 20):
        # A = 0 .. m - 1, B = 1 .. m - 1: the merge path at every tile edge
        # (an even diagonal) falls between A's and B's copy of one word.
        merge_case(f"an equal pair at every tile edge, n={2 * m - 1}", ar(m), ar(m)[1:])
        merge_case(f"a misaligned head, n={2 * m - 3}", ar(m)[1:], ar(m)[2:] * 3)
    run = ar(3 * tile)
    merge_case("counts that saturate on the fused add", run, run.clone(), 5, 5)
    for m in (tile - 1, 3 * tile + 5, 1 << 20):
        wa = torch.unique(sorted_words(m, m, 32, gen, device))
        wb = torch.unique(torch.cat([wa[::3], sorted_words(m, m, 32, gen, device)]))
        merge_case(f"k=32 signed words, na={wa.shape[0]} nb={wb.shape[0]}", wa, wb)
    lines.append(f"run_counts and merge_counts ({n_cmp} inputs: n = 0 .. 3 tiles + 5 and 2^20 "
                 "at k = 31 and 32, runs of a tile's length and across tile edges, one run, "
                 "one over 4 tiles, all distinct, saturating weights, inputs 8-24 bytes off a "
                 "16-byte boundary; empty, disjoint, interleaved, identical and shifted runs, an "
                 "equal pair at every tile edge, k = 32 signed words, counts that saturate on "
                 "the add; with and without the threshold) == plain")


def transpose_bits_checks(device: torch.device, gen, record, lines: list) -> dict:
    """transpose_bits_device (the byte entry of the bit_transpose kernel)
    against its plain version, unpack -> transpose -> pack: [2048, 2^17]
    bytes (a 2^20-bit chunk of 2048 filters), timed, and F, B and P each
    ragged. Returns the timed shape's numbers."""
    shapes = [(NUM_FILTER, 1 << 17, NUM_FILTER), (5, 3, 8), (40, 7, 48), (33, 4, 40),
              (2000, 1001, 2048), (100, 64, 4096), (2047, 4099, 2048)]
    timed = {}
    for F, B, P in shapes:
        f = torch.randint(0, 256, (F, B), dtype=torch.uint8, device=device, generator=gen)
        got = tt.transpose_bits_device(f, P)
        want = tt.transpose_bits_ref(f, P)
        check(got.shape == (B * 8, P // 8) and got.dtype == torch.uint8,
              f"transpose_bits_device {F} x {B}: shape {tuple(got.shape)}")
        err = max_abs_err(got, want)
        check(err == 0, f"transpose_bits_device differs from its plain version at "
                        f"[{F}, {B}] P={P} ({err})")
        record("bit_transpose", f"bytes [{F}, {B}] P={P}", err, log=False)
        if not timed:
            ms = cuda_ms(lambda: tt.transpose_bits_device(f, P), 20)
            plain = cuda_ms(lambda: tt.transpose_bits_ref(f, P), 2)
            # Bytes: the filters in, the slices out. Operations: the word
            # transpose's 30 a 32-bit word.
            timed = {"kernel": "transpose_bits_device (entry of bit_transpose)",
                     "shape": f"[{F}, {B}] uint8 P={P}", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "library_ms": None,
                     **bound(nbytes_of(f, got), 30 * f.numel() // 4)}
            lines.append(f"transpose_bits_device [{F}, {B}] P={P}: {ms:.4f} ms "
                         f"({nbytes_of(f, got) / ms / 1e6:.1f} GB/s) plain {plain:.3f} ms")
        del f, got, want
    lines.append("transpose_bits_device at " + ", ".join(
        f"[{F}, {B}] P={P}" for F, B, P in shapes[1:]) + " == plain")
    torch.cuda.empty_cache()
    return timed


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

    search_checks(device, gen, results, lines)

    def record(name, tag, err, ms=None, plain=None, note="", nbytes=0, nops=0, log=True):
        """One comparison; ``ms`` None: checked, not timed. A kernel's first
        timed comparison (the main path's shape) gives its line of the
        result, with the bound of ``nbytes`` and ``nops``. ``log`` False:
        the caller sums many comparisons up in a line of its own."""
        check(err == 0, f"{name} differs from its plain version at {tag} (max err {err})")
        if log:
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

    # select_runs and bloom_set_bits over radix_sort_pairs' outputs: first
    # the fused batch's valid windows, which the main path hands them (the
    # kernels line's row), then all 237 M pairs at 30% invalid (an invalid
    # tail; the row of PRs 5 and 6).
    num_acc = ingest["num_acc"]
    L, nh = ingest["log2_len"], ingest["num_hash"]
    slot = torch.tensor(list(range(num_acc)) + [-1], dtype=torch.int32, device=device)
    for tag, (acc_s, words_s) in sort_checks(device, gen, ingest, record, lines,
                                             results).items():
        n = acc_s.shape[0]
        sel, nv = tcount.select_runs(acc_s, words_s, num_acc, MIN_COUNT)
        ref_sel, ref_nv = tcount.select_runs_ref(acc_s, words_s, num_acc, MIN_COUNT)
        err = max(max_abs_err(sel, ref_sel), max_abs_err(nv, ref_nv))
        check(int(nv.sum()) > 0, "select_runs selected nothing")
        del ref_sel, ref_nv
        out_nv = torch.zeros_like(nv)
        ms = cuda_ms(lambda: kernels.launch(
            "select_runs", acc_s.data_ptr(), words_s.data_ptr(), sel.data_ptr(),
            out_nv.data_ptr(), n, num_acc, MIN_COUNT, stream()), 10)
        plain = cuda_ms(lambda: tcount.select_runs_ref(acc_s, words_s, num_acc, MIN_COUNT), 2)
        # Bytes: the sorted pairs in, the flags and counts out. Operations:
        # about 10 a position (two compares with the neighbours, the run
        # length).
        record("select_runs", f"{tag} n={n} num_acc={num_acc} min_count={MIN_COUNT}", err, ms,
               plain, f" ({n / ms / 1e6:.1f} G positions/s)",
               nbytes_of(acc_s, words_s, sel, nv), 10 * n)

        got = tcount.bloom_set_bits(acc_s, words_s, sel, slot, k, nh, L)
        want = tcount.bloom_set_bits_ref(acc_s, words_s, sel, slot, k, nh, L)
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: kernels.launch(
            "bloom_set_bits", acc_s.data_ptr(), words_s.data_ptr(), sel.data_ptr(),
            slot.data_ptr(), got.data_ptr(), n, num_acc, k, nh, L, got.shape[1], stream()), 10)
        plain = cuda_ms(lambda: tcount.bloom_set_bits_ref(acc_s, words_s, sel, slot, k, nh, L),
                        2)
        n_sel = int(nv.sum())
        # Bytes: the flag of every position, the (accession, word) pair of
        # the selected ones alone (the rest are never read), the filter
        # images out once. Operations: murmur for the selected words, 3 a
        # position to skip the rest.
        pair_bytes = acc_s.element_size() + words_s.element_size()
        record("bloom_set_bits", f"{tag} n={n} selected={n_sel} num_acc={num_acc} L={L} nh={nh}",
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

    # bloom_set_bits at phase 14's build: its windows over 64 accessions,
    # as many selected as the exact count kept, 2^26-bit images.
    prod = ingest["prod_l"]
    n, num_acc, L, nh = prod["windows"], prod["num_acc"], prod["log2_len"], prod["num_hash"]
    acc = torch.randint(0, num_acc, (n,), device=device, generator=gen).sort().values
    words = torch.randint(0, 1 << 62, (n,), device=device, generator=gen)
    sel = torch.rand((n,), device=device, generator=gen) < prod["selected"] / n
    slot = torch.tensor(list(range(num_acc)) + [-1], dtype=torch.int32, device=device)
    got = tcount.bloom_set_bits(acc, words, sel, slot, k, nh, L)
    ms = cuda_ms(lambda: kernels.launch(
        "bloom_set_bits", acc.data_ptr(), words.data_ptr(), sel.data_ptr(), slot.data_ptr(),
        got.data_ptr(), n, num_acc, k, nh, L, got.shape[1], stream()), 10)
    n_sel = int(sel.sum())
    b = bound(nbytes_of(sel, slot, got) + n_sel * (acc.element_size() + words.element_size()),
              n_sel * murmur_ops(k, nh) + 3 * n)
    record("bloom_set_bits", f"phase 14's L={L} build n={n} selected={n_sel} num_acc={num_acc} "
           f"nh={nh}", max_abs_err(got, tcount.bloom_set_bits_ref(acc, words, sel, slot, k, nh, L)),
           ms, cuda_ms(lambda: tcount.bloom_set_bits_ref(acc, words, sel, slot, k, nh, L), 2),
           f" (bound {b['bound_ms']:.4f} ms by {b['bound_by']})")
    del acc, words, sel, got
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
    merge_checks(device, gen, record, lines, results, ingest["chunked"])
    results["transpose_bits_device"] = transpose_bits_checks(device, gen, record, lines)
    tiled_edge_checks(device, seed, record, lines)
    small_block_checks(device, seed, results, lines)
    sriracha_kernel_checks(device, seed, record, lines, results)
    print("phase 4 kernels == plain versions, bit for bit: " + "; ".join(lines), flush=True)
    return results


def select_runs_edge_pairs(rng, tile: int, start: int, num_acc: int):
    """Sorted (acc, word) pairs, numpy int64, that put every feature a tiled
    select_runs can get wrong at a known place after position ``start`` (a
    multiple of ``tile``; filler before it): a negative accession first; an
    accession boundary 13 positions into a tile; a run of 6 that starts on
    a tile's last position; 40 accessions of 10 positions inside one tile;
    a run of 5 that ends on a tile's first position; a run of tile + 10; an
    accession boundary on a tile edge; ``acc == num_acc`` and
    ``acc > num_acc`` last. start + 5 * tile + 5 positions; the callers
    also cut it shorter."""
    accs, lengths = [], []   # arrays of (accession, length) runs; a new word a run
    pos = 0

    def run(acc, length):
        nonlocal pos
        accs.append(np.array([acc], dtype=np.int64))
        lengths.append(np.array([length], dtype=np.int64))
        pos += length

    def fill_to(target, acc):
        """Runs of 1 to 9 positions of accession ``acc`` up to ``target``."""
        nonlocal pos
        need = target - pos
        if need <= 0:
            return
        lens = rng.choice(np.array([1, 1, 2, 3, 4, 5, 6, 9]), size=need)
        ends = np.cumsum(lens)
        last = int(np.searchsorted(ends, need))
        lens = lens[: last + 1]
        lens[last] -= ends[last] - need
        accs.append(np.full(lens.shape, acc, dtype=np.int64))
        lengths.append(lens)
        pos = target

    run(-2, 3)
    fill_to(start + 13, 0)
    fill_to(start + tile - 1, 1)
    run(1, 6)
    for acc in range(2, 42):
        fill_to(pos + 10, acc)
    fill_to(start + 2 * tile - 4, 42)
    run(42, 5)
    run(42, tile + 10)
    fill_to(start + 4 * tile, 42)
    fill_to(start + 5 * tile - 4, 43)
    run(num_acc, 5)
    run(num_acc + 2, 4)
    check(pos == start + 5 * tile + 5 and num_acc >= 44, "select_runs edge data")
    accs, lengths = np.concatenate(accs), np.concatenate(lengths)
    return (np.repeat(accs, lengths),
            np.repeat(np.arange(accs.shape[0], dtype=np.int64) * 7919 + 5, lengths))


# csrc/counting.cu: the tiled select_runs kernel takes tiles of 2048
# positions from n = 2^20 and look-aheads up to 32 pairs (min_count 33);
# the one-position-a-thread kernel the rest. csrc/bit_transpose.cu: the
# tiled kernel takes matrices of more than 4096 32 x 32 bit tiles.
SELECT_RUNS_TILE, SELECT_RUNS_TILED_MIN_N, SELECT_RUNS_HALO = 2048, 1 << 20, 32
BIT_TRANSPOSE_SMALL_TILES = 4096


def tiled_edge_checks(device: torch.device, seed: int, record, lines: list) -> None:
    """select_runs and bit_transpose, the two kernels that work in tiles, at
    the shapes where a tile's edge can go wrong, each against its plain
    version bit for bit. select_runs, below the tiled kernel's least n and
    above it: n = 1 and n a tile - 1, a tile, a tile + 1, 3 tiles + 5 and
    5 tiles + 5 past the start of ``select_runs_edge_pairs``' features, at
    min_count 1, 2, 5, 33 (the whole staged halo), 34 (past it) and a
    tile + 3; arrays that are not 16-byte aligned; every position invalid;
    num_valid added over two launches. bit_transpose: F in 32, 64, 2048,
    2080 x W in 1, 7, 8, 33, 130, 1024 on random words, the same ragged
    widths on matrices tall or wide enough for the tiled kernel at each of
    its tile shapes, a matrix with one set bit at each corner, and the
    ingest's [32, 65536], timed."""
    rng = np.random.default_rng(seed + 6)
    stream = torch.cuda.current_stream(device).cuda_stream
    num_acc, n_cmp = 44, 0
    tile = SELECT_RUNS_TILE
    for start in (0, SELECT_RUNS_TILED_MIN_N):
        acc_np, words_np = select_runs_edge_pairs(rng, tile, start, num_acc)
        acc_all = torch.from_numpy(acc_np).to(device)
        words_all = torch.from_numpy(words_np).to(device)
        cuts = [(0, start + e) for e in (tile - 1, tile, tile + 1, 3 * tile + 5, 5 * tile + 5)]
        cuts += [(0, 1), (3, 4), (1, start + 3 * tile + 5)]   # (1, ...): 8-byte aligned only
        for lo, hi in cuts:
            a, w = acc_all[lo:hi], words_all[lo:hi]
            for m in (1, 2, 5, SELECT_RUNS_HALO + 1, SELECT_RUNS_HALO + 2, tile + 3):
                sel, nv = tcount.select_runs(a, w, num_acc, m)
                ref_sel, ref_nv = tcount.select_runs_ref(a, w, num_acc, m)
                err = max(max_abs_err(sel, ref_sel), max_abs_err(nv, ref_nv))
                record("select_runs", f"edges [{lo}:{hi}] min_count={m}", err, log=False)
                n_cmp += 1
                if hi == acc_all.shape[0]:
                    check(int(nv.sum()) > 0, f"select_runs edges: nothing selected at m={m}")
                    check(m > 1 or int((nv > 0).sum()) == num_acc, "select_runs edges: accessions")
        # Every position invalid; then the kernel adds into num_valid.
        a = torch.full((start + tile + 7,), num_acc, dtype=torch.int64, device=device)
        sel, nv = tcount.select_runs(a, words_all[: a.shape[0]], num_acc, 2)
        check(not bool(sel.any()) and not bool(nv.any()), "select_runs selected an invalid pair")
        ref_sel, ref_nv = tcount.select_runs_ref(acc_all, words_all, num_acc, 2)
        sel = torch.empty_like(ref_sel)
        nv = torch.zeros_like(ref_nv)
        for _ in range(2):
            kernels.launch("select_runs", acc_all.data_ptr(), words_all.data_ptr(),
                           sel.data_ptr(), nv.data_ptr(), acc_all.shape[0], num_acc, 2, stream)
        record("select_runs", f"edges n={acc_all.shape[0]}, two launches into one num_valid",
               max(max_abs_err(sel, ref_sel), max_abs_err(nv, 2 * ref_nv)), log=False)
    lines.append(f"select_runs tile edges (below and above n = 2^20; {n_cmp} comparisons: "
                 "n = 1, tile - 1 .. 5 tiles + 5; runs across tile edges; 40 accessions in a "
                 "tile; min_count 1, 2, 5, 33, 34, tile + 3; unaligned; all invalid; two "
                 "launches added) == plain")

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 6)
    shapes = [(F, W) for F in (32, 64, 2048, 2080) for W in (1, 7, 8, 33, 130, 1024)]
    # Ragged widths on the tiled kernel: 8 row groups a tile (tall), then
    # 1, 2 and 4 (F = 32, 64, 128), widths that end inside a tile.
    tiled = [(32 * 4100, W) for W in (1, 7, 8, 33)] + [(32, 4099), (32, 4100), (64, 2051),
                                                       (128, 1027), (2080, 130)]
    check(all(F // 32 * W > BIT_TRANSPOSE_SMALL_TILES for F, W in tiled),
          "bit_transpose edges: a shape meant for the tiled kernel is too small")
    for F, W in shapes + tiled:
        x = random_words((F, W), gen, device)
        record("bit_transpose", f"[{F}, {W}]", max_abs_err(
            tt.packed_bit_transpose(x), tt.packed_bit_transpose_ref(x)), log=False)
    x = torch.zeros((2080, 130), dtype=torch.int32, device=device)   # the tiled kernel
    x[0, 0] = x[-1, 0] = 1
    x[0, -1] = x[-1, -1] = -2**31
    got = tt.packed_bit_transpose(x)
    check(int((got != 0).sum()) == 4 and int(got[0, 0]) == 1 and int(got[0, -1]) == -2**31
          and int(got[-1, 0]) == 1 and int(got[-1, -1]) == -2**31,
          "bit_transpose: the corner bits did not land in the corners")
    record("bit_transpose", "corner bits of [2080, 130]",
           max_abs_err(got, tt.packed_bit_transpose_ref(x)), log=False)
    lines.append("bit_transpose at F = 32, 64, 2048, 2080 x W = 1, 7, 8, 33, 130, 1024, at "
                 + ", ".join(f"[{F}, {W}]" for F, W in tiled)
                 + " and the corner bits of [2080, 130] == plain")
    x = random_words((32, (1 << 21) // 32), gen, device)
    got = tt.packed_bit_transpose(x)
    err = max_abs_err(got, tt.packed_bit_transpose_ref(x))
    ms = cuda_ms(lambda: kernels.launch("bit_transpose", x.data_ptr(), got.data_ptr(),
                                        x.shape[0], x.shape[1], stream), 20)
    plain = cuda_ms(lambda: tt.packed_bit_transpose_ref(x), 2)
    record("bit_transpose", f"[{x.shape[0]}, {x.shape[1]}] (an ingest batch)", err, ms, plain)


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
        acc_s, words_s = tcount.sort_windows(acc, flat, k, 4)
        ref_acc, ref_words = tcount.sort_windows_ref(acc, flat)
        errs["radix_sort_pairs"] += diff(acc_s, ref_acc) + diff(words_s, ref_words)
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
    # murmur32 at every instance of its kernel: k = 1..32 x nh = 1..8, and
    # nh = 9 (the instance with nh at run time), on 4099 words of 2k random
    # bits; its entry refuses an output 4 bytes off a 16-byte boundary.
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    n = 4099
    full = ((random_words((n,), gen, device).long() << 32)
            | (random_words((n,), gen, device).long() & 0xFFFFFFFF))
    for k in range(1, 33):
        flat = full if k == 32 else full & ((1 << (2 * k)) - 1)
        for nh in range(1, 10):
            ref = th.murmur32_ref(flat, k, nh)
            errs["murmur32"] += (diff(th.murmur32(flat, k, nh), ref)
                                 + diff(th.slice_indices(flat, k, nh, 13), ref & ((1 << 13) - 1)))
    buf = torch.empty(n * 4 + 1, dtype=torch.int32, device=device)
    check(kernels.get_lib().kw_murmur32(full.data_ptr(), buf[1:].data_ptr(), n, 31, 4,
                                        0xFFFFFFFF, torch.cuda.current_stream(device).cuda_stream)
          != 0, "murmur32 took an output off a 16-byte boundary")
    lines.append(f"murmur32 and slice_indices at k = 1-32 x nh = 1-9 on {n} words == plain; an "
                 "output 4 bytes off a 16-byte boundary refused")
    for name, err in errs.items():
        check(err == 0, f"{name} differs from its plain version on the small block ({err})")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    lines.append("canonical_kmers (packed and ASCII), murmur32, slice_indices, "
                 "radix_sort_pairs, select_runs, "
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


def subject_sets(genomes: np.ndarray, k: int) -> list[tuple[str, np.ndarray]]:
    """load_subject_kmers' output for the genomes: sorted unique canonical
    words."""
    return [(f"query {i}", np.unique(canonical_kmers_native(ACGT[g].tobytes(), k)))
            for i, g in enumerate(genomes)]


def wide_rows(rng, genomes: np.ndarray, k: int, W: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """16 rows [16, W] of the block kernel's buckets (W - k + 1 above 512
    windows) on ``device``: rows of 0, 1, k - 1, k, 513, half the width, the
    width less one and the width; an every-byte row, a lowercase row and a
    run of Ns; every fifth drawn from ``genomes``."""
    b, lengths = read_block(rng, genomes, 16, W, W, SUB_RATE)
    lengths[:8] = [0, 1, k - 1, k, 513, W // 2, W - 1, W]
    for r, n in enumerate(lengths):
        b[r, n:] = 0
    b[8, :512] = np.arange(512) % 256
    b[9, : lengths[9]] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=lengths[9])]
    b[10, 700:730] = ord("N")
    return torch.from_numpy(b).to(device), torch.from_numpy(lengths).to(device)


def edge_rows(rng, genomes: np.ndarray, k: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """[8, 32768] reads on ``device``: rows of 0, k - 1, 16385, 16384 + k -
    1 and 16384 + k bases and of 20, 26 and 32 kbp, each from a subject
    with SUB_RATE substitutions (repeated past the subject's end), 100 Ns
    in the 16385-base row."""
    lengths = np.array([0, k - 1, 16385, 16384 + k - 1, 16384 + k, 20_000, 26_000, 32_000],
                       np.int32)
    b = np.zeros((8, 1 << 15), np.uint8)
    for r, n in enumerate(lengths):
        b[r, :n] = ACGT[np.resize(mutate(rng, genomes[r]), n)]
    b[2, 5000:5100] = ord("N")
    return torch.from_numpy(b).to(device), torch.from_numpy(lengths).to(device)


# sriracha_counts' ms (launches in a row) before the block kernel took its
# rows of at most 2^14 windows, when a block of at most 256 threads sorted
# each such row (NVIDIA H100 80GB HBM3, 700.00 W): (probe, k, shape) -> ms.
COUNTS_FIRST_MS = {
    ("lut", 11, "[512, 2048]"): 0.0732, ("lut", 11, "[64, 16384]"): 0.3190,
    ("lut", 11, "[512, 16384]"): 1.2535, ("hash", 21, "[512, 2048]"): 0.1069,
    ("hash", 21, "[64, 16384]"): 0.4273, ("hash", 21, "[512, 16384]"): 1.6222,
    ("lut", 11, "[4, 32768], 3 long reads,"): 0.1272,
    ("hash", 21, "[4, 32768], 3 long reads,"): 0.1427,
    ("hash", 11, "[4, 32768], 3 long reads,"): 0.1439,
    ("lut", 11, "[512, 32768], 3 long reads,"): 0.1494,
    ("hash", 21, "[512, 32768], 3 long reads,"): 0.1683,
}


def sriracha_kernel_checks(device: torch.device, seed: int, record, lines: list,
                           results: dict) -> None:
    """sriracha_reads and sriracha_counts (both probes), subject_table and
    canonical_kmers' ASCII entry (at phase 8's batch shapes, timed) against
    their plain versions, bit for bit: at phase 8's batch shape (512 x 256,
    150 bp reads, 40 subjects of 30 kbp) at k = 21 and 11, timed, the fused
    sriracha_reads beside the two launches it replaces on the same inputs,
    and so at bench.sriracha's step (512 x 128, k = 21) and a whole span
    (8192 x 256, k = 21 and 11); on reads of 1.5 kbp and 15 kbp (512 x
    2048, 64 x 16384 and 512 x 16384; the hash table at k = 21, the LUT at
    k = 11) the block kernel sriracha_block timed beside the two launches
    it replaces, and sriracha_counts alone (rows above the warp kernel's
    512 windows and within a tile); on a small block holding every byte
    value at k = 3, 13, 14, 16, 31, 32, and the block kernel on rows of the
    2048 bucket and of 2^14 + k - 1 bases (rows of 0, 1, k - 1, k, 513,
    half, all but one and all of the width, N-bearing, lower case, every
    byte) at those k;
    sriracha_reads on rows of 0, 1, k - 1 and k bases at every k = 1-32,
    and at widths 150, 200 and 543 and in views one byte off a 16-byte
    boundary at k = 1, 11, 21, 32; on batches of the path's long-read
    shape (4 x 2^15 and 512 x 2^15: reads of 2^15 bases and 20 kbp, the
    rest empty; the tiled sort), timed; sriracha_counts on [8, 32768] rows
    of 0, k - 1, 16385, 16384 + k - 1, 16384 + k and 20-32 kbp at every k
    branch, timed at k = 11 and 21, and from words 8 bytes off a 16-byte
    boundary; on batches that mix rows of 0, 1,
    2^14 - 1, 2^14, 2^14 + 1 and more valid words
    (2^15 and 2^16 buckets). Then both probes timed at 8 k, 64 k, 256 k and
    1 M k-mers per group at k = 11, by both routes. A timed sriracha_counts
    line names the first design's time at its shape (COUNTS_FIRST_MS)."""
    rng = np.random.default_rng(seed + 5)
    stream = torch.cuda.current_stream(device).cuda_stream
    genomes = rng.integers(0, 4, size=(SR_SUBJECTS, SR_SUBJECT_BP), dtype=np.uint8)
    b, lengths = read_block(rng, genomes, 512, 256, READ_LEN, SUB_RATE)
    reads, lens = torch.from_numpy(b).to(device), torch.from_numpy(lengths).to(device)

    def fused(tag, reads, lens, tables, timed):
        """One comparison of the fused entry (sriracha_reads or
        sriracha_block, by the width: ``fused_kernel``) with
        read_batch_counts_ref; ``timed``: ``sriracha_routes``, which runs
        it and the two launches it replaces (canonical_kmers' ASCII entry
        and sriracha_counts) once each on the same inputs, holds each
        route's output to the plain version's, and times them in CUDA
        graphs in the order fused, words, words, fused."""
        check(tsr.fused_route(reads.shape[1], tables.k), f"{tag}: not the fused route's shape")
        name = f"{tsr.fused_kernel(reads.shape[1], tables.k)}_{tables.route}"
        got = tsr.read_batch_counts(reads, lens, tables)
        want = tsr.read_batch_counts_ref(reads, lens, tables)
        err = max_abs_err(got, want)
        if not timed:
            record(name, tag, err, log=False)
            return
        same, t = sriracha_routes(reads, lens, tables, want)
        check(all(same.values()), f"{name} {tag}: a route differs from the plain version {same}")
        plain = cuda_ms(lambda: tsr.read_batch_counts_ref(reads, lens, tables), 3)
        nbytes, nops = reads_work(reads, lens, tables)
        b = bound(nbytes, nops)
        ms, words_ms = sum(t["fused"]) / 2, sum(t["words"]) / 2
        first = name not in results
        record(name, tag, err, ms, plain, "", nbytes, nops, log=False)
        if first:
            results[name]["words_route_ms"] = words_ms
        lines.append(f"{name} {tag}: fused {t['fused'][0]:.4f} / {t['fused'][1]:.4f} ms graph "
                     f"(bound {b['bound_ms']:.5f} ms by {b['bound_by']}: {nbytes} bytes, {nops} "
                     f"operations; share {b['bound_ms'] / ms:.3f}); words route (canonical_kmers "
                     f"+ sriracha_counts_{tables.route}) {t['words'][0]:.4f} / "
                     f"{t['words'][1]:.4f} ms graph; {int(want[:, tables.ns + 1].sum())} distinct "
                     f"words; plain {plain:.3f} ms")

    def counts(tag, words, valid, lens, tables, timed):
        """One comparison of sriracha_counts with its plain version; a timed
        one beside the first design's time at its shape, where known."""
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
            nbytes, nops = counts_work(words, valid, lens, tables)
        hits = int(want[:, : tables.ns].sum())
        check(hits > 0, f"sriracha_counts {tag}: no subject hit")
        n_long = int((want[:, tables.ns] > tsr.MAX_SHARED_WORDS).sum())
        note = f" ({hits} hits, {n_long} rows above a tile"
        if timed:
            b = bound(nbytes, nops)
            note += (f"; bound {b['bound_ms']:.5f} ms by {b['bound_by']}: {nbytes} bytes, "
                     f"{nops} operations; share {b['bound_ms'] / ms:.3f}")
            first = COUNTS_FIRST_MS.get((tables.route, tables.k, tag.split(" k=")[0]))
            if first is not None:
                note += f"; the first design {first:.4f} ms"
        record(f"sriracha_counts_{tables.route}", tag, err, ms, plain, note + ")", nbytes, nops)

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
            luts = tsr.LutTables(table, k, len(subj))
            fused(f"[512, 256] k={k}", reads, lens, luts, True)
            counts(f"[512, 256] k={k}", words, valid, lens, luts, True)
            del sm, table
        hashes = tsr.build_hash_tables(subj, k, device)
        fused(f"[512, 256] k={k}", reads, lens, hashes, True)
        counts(f"[512, 256] k={k}", words, valid, lens, hashes, True)
        # bench.sriracha's step (128 bp reads in the 128 bucket) at k = 21;
        # a whole span at both k.
        shapes = [(8192, 256, READ_LEN)] + ([(512, 128, 128)] if k == 21 else [])
        for B, L, read_len in shapes:
            b5, lengths5 = read_block(rng, genomes, B, L, read_len, SUB_RATE)
            r5, l5 = torch.from_numpy(b5).to(device), torch.from_numpy(lengths5).to(device)
            for tables in ([luts] if k <= 14 else []) + [hashes]:
                fused(f"[{B}, {L}] k={k}", r5, l5, tables, True)
        # Reads of 1.5 kbp and 15 kbp (the buckets of 1024-16384 bases), by
        # the LUT at k = 11 and the hash table at k = 21: the block kernel
        # timed beside the two launches it replaces, and sriracha_counts
        # alone on those rows (the short-row design).
        for B, L, read_len in ((512, 2048, 1500), (64, 16384, 15000), (512, 16384, 15000)):
            b8, lengths8 = read_block(rng, genomes, B, L, read_len, SUB_RATE)
            r8, l8 = torch.from_numpy(b8).to(device), torch.from_numpy(lengths8).to(device)
            fused(f"[{B}, {L}] k={k}", r8, l8, luts if k <= 14 else hashes, True)
            w8, v8 = tk.canonical_kmers(r8, k)
            counts(f"[{B}, {L}] k={k}", w8, v8, l8, luts if k <= 14 else hashes, True)
            del b8, r8, w8, v8
            torch.cuda.empty_cache()
        del hashes
    torch.cuda.empty_cache()

    # Every byte value, every k branch: 3 (a 64-entry table), 13, 14 (the
    # largest LUT, 1 GiB a group), 16, 31 and 32 (the sign bit).
    b2, lengths2 = read_block(rng, genomes, 64, 256, READ_LEN, SUB_RATE)
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
        wide = [wide_rows(rng, genomes, k, W, device) for W in (2048, 16384 + k - 1)]
        for tables in routes:
            counts(f"small [64, 256] k={k}", words, valid, small_lens, tables, False)
            fused(f"small [64, 256] k={k}", small, small_lens, tables, False)
            for r9, l9 in wide:
                fused(f"edge rows [{r9.shape[0]}, {r9.shape[1]}] k={k}", r9, l9, tables, False)
        del routes, wide
        torch.cuda.empty_cache()

    # sriracha_reads at every k on rows of 0, 1, k - 1, k, k + 1 and 64
    # bases (two groups of subjects drawn from the rows' own words).
    for k in range(1, 33):
        starts = rng.integers(0, SR_SUBJECT_BP - 64, size=8)
        b6 = ACGT[np.stack([genomes[i % 5][a : a + 64] for i, a in enumerate(starts)])]
        lengths6 = np.array([0, 1, k - 1, k, k + 1, 64, 33, 64], np.int32)
        for r, n in enumerate(lengths6):
            b6[r, n:] = 0
        b6[6, 10] = ord("N")
        subj = [(f"s{i}", np.unique(canonical_kmers_native(
            b6[i % 8, : lengths6[i % 8]].tobytes(), k))[i % 3 :: 1 + i % 2]) for i in range(40)]
        r6, l6 = torch.from_numpy(b6).to(device), torch.from_numpy(lengths6).to(device)
        for tables in ([tsr.build_lut_tables(subj, k, device)] if k <= 13 else []) + [
                tsr.build_hash_tables(subj, k, device)]:
            fused(f"rows of 0, 1, k-1, k bases k={k}", r6, l6, tables, False)
    # The fused kernel's byte-load staging (rows not a multiple of 16 bytes
    # wide, or reads off a 16-byte boundary): widths 150, 200 and, at
    # k = 32, 543 (512 windows); widths 256 and 512 in a view one byte off a
    # 16-byte boundary. Rows of 0, 1, k - 1, k, k + 1, the width less one
    # and the width bases.
    staged = []
    for k in (1, 11, 21, 32):
        subj = subject_sets(genomes, k)
        routes = [tsr.build_hash_tables(subj, k, device)]
        if k <= 13:
            routes.append(tsr.build_lut_tables(subj, k, device))
        for W, off in [(150, 0), (200, 0), (256, 1), (512, 1)] + ([(543, 0)] if k == 32 else []):
            b7, lengths7 = read_block(rng, genomes, 40, W, W, SUB_RATE)
            lengths7[:7] = [0, 1, k - 1, k, k + 1, W - 1, W]
            for r, n in enumerate(lengths7):
                b7[r, n:] = 0
            r7 = torch.zeros(40 * W + off, dtype=torch.uint8, device=device)[off:].view(40, W)
            r7.copy_(torch.from_numpy(b7))
            check(r7.data_ptr() % 16 == off, f"[40, {W}]: reads at {r7.data_ptr() % 16} mod 16")
            for tables in routes:
                tag = f"[40, {W}]{' one byte off' if off else ''} k={k}"
                fused(tag, r7, torch.from_numpy(lengths7).to(device), tables, False)
                staged.append(f"{tag} {tables.route}")
        del routes
    lines.append("sriracha_reads (both probes) == plain on the every-byte block at k = 3, 13, "
                 "14, 16, 31, 32, on rows of 0, 1, k - 1, k, k + 1 and 64 bases at k = 1-32, "
                 f"and through the byte-load staging on {len(staged)} batches: "
                 + ", ".join(staged))

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

    # The 32768 bucket's edge rows at every k branch: rows of 0, k - 1,
    # 16385, 16384 + k - 1 and 16384 + k bases (both sides of 2^14 windows:
    # the block kernel from words, then the tile chain) and of 20, 26 and
    # 32 kbp, by both probes; timed at k = 11 (LUT) and 21 (hash); at k =
    # 11, 21 and 32 also from words and flags 8 bytes off a 16-byte
    # boundary.
    edged = []
    for k in (1, 3, 11, 13, 14, 16, 17, 21, 31, 32):
        subj = subject_sets(genomes, k)
        routes = [tsr.build_hash_tables(subj, k, device)]
        if k <= tsr.MAX_TABLE_K_CUDA:
            routes.append(tsr.build_lut_tables(subj, k, device))
        edge_reads, edge_lens = edge_rows(rng, genomes, k, device)
        words, valid = tk.canonical_kmers(edge_reads, k)
        tag = f"[8, 32768] k={k}"
        for tables in routes:
            counts(tag, words, valid, edge_lens, tables,
                   (k, tables.route) in ((11, "lut"), (21, "hash")))
            edged.append(f"k={k} {tables.route}")
        if k in (11, 21, 32):
            n = words.numel()
            w_off = torch.empty(n + 1, dtype=torch.int64, device=device)[1:].view(words.shape)
            v_off = torch.empty(n + 8, dtype=torch.bool, device=device)[8:].view(valid.shape)
            w_off.copy_(words)
            v_off.copy_(valid)
            check(w_off.data_ptr() % 16 == 8 and v_off.data_ptr() % 16 == 8,
                  f"words at {w_off.data_ptr() % 16}, flags at {v_off.data_ptr() % 16} mod 16")
            for tables in routes:
                counts(f"{tag} 8 bytes off", w_off, v_off, edge_lens, tables, False)
                edged.append(f"k={k} {tables.route} 8 bytes off")
            del w_off, v_off
        del routes, words, valid, edge_reads
        torch.cuda.empty_cache()
    lines.append("sriracha_counts == plain on [8, 32768] (rows of 0, k - 1, 16385, 16384 + k - 1, "
                 "16384 + k, 20000, 26000 and 32000 bases): " + ", ".join(edged))

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
            got = tsr.read_batch_counts(reads, lens, tables, out)
            check(torch.equal(got, tsr.read_batch_counts_ref(reads, lens, tables)),
                  f"sriracha_reads_{tables.route} differs at n={n}")
            launch = tsr.reads_launch(reads, lens, tables, out)
            times.append(cuda_ms(lambda: kernels.launch(*launch), 20))
            del tables
        cross.append(f"n={n}: lut {times[0]:.4f} ms, hash {times[2]:.4f} ms (sriracha_counts); "
                     f"lut {times[1]:.4f} ms, hash {times[3]:.4f} ms (sriracha_reads)")
    lines.append("sriracha crossover [512, 256] k=11, 32 subjects, launches in a row: "
                 + "; ".join(cross))


class PhaseWalls:
    """Each phase's wall seconds on the host's clock: ``with walls("8
    sriracha"):`` prints the phase's seconds when it ends (a phase timed
    twice adds up), and ``summary`` gives every phase's in the order run."""

    def __init__(self):
        self.walls: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            wall = time.perf_counter() - t0
            self.walls[phase] = self.walls.get(phase, 0.0) + wall
            print(f"phase {phase}: {wall:.1f} s", flush=True)

    def summary(self) -> str:
        return (f"phase walls (s): {json.dumps({k: round(v, 1) for k, v in self.walls.items()})}"
                f"; {sum(self.walls.values()):.1f} s in all")


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
    walls = PhaseWalls()
    deadline = time.perf_counter() + SMOKE_SECONDS - SMOKE_RESERVE
    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    with walls("build"):
        t0 = time.perf_counter()
        # Phase 15's variant library and the host library (g++) beside the kernels.
        with ThreadPoolExecutor(2) as pool:
            variant = pool.submit(search_phases.get_lib)
            native = pool.submit(timed, native_available)
            lib = kernels.build()
            variant.result()
        print(f"build: {os.path.relpath(lib)} and {VARIANT_SOURCE} in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"torch {torch.__version__} CUDA {torch.version.cuda}; {card}", flush=True)
        built, secs = native.result()
        check(built, "the host library (native/kwage_native.cpp, g++) did not build")
        print(f"build: host library in {secs:.1f} s, beside the kernels", flush=True)

    if args.profile:
        with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
            shapes = run_ingest(work, device, INGEST, args.seed, profile=True)
            run_remote_ingest(work, device, shapes["run"], profile=True)
        with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
            run_sriracha(work, device, args.seed, profile=True)
        print(card)
        return 0

    # Phase 15's dry scheduler first, on a disk nothing has written to yet
    # (SCHEDULER_RUNS); it launches nothing.
    with walls("15 dry_sched"):
        scheduler, _ = run_tools(device, deadline, SCHEDULER_RUNS)
    # Each path runs with the launch counts zeroed just before it and read
    # just after; phase 4's comparison launches are not counted.
    paths = {}

    def path(name: str, phase: str, fn, *fargs):
        """Run one path under its wall, its counts zeroed just before it and
        read just after (into ``paths[name]``); return its result."""
        torch.cuda.empty_cache()
        with walls(phase):
            kernels.reset_launch_counts()
            out = fn(*fargs)
            paths[name] = kernels.launch_counts()
        return out

    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        main_path = path("search", "1-3 search", run_main_path, work, device, NUM_FILTER,
                         LOG2_FILTER_LEN, COPIES, args.seed)
        path("mesh", "9 mesh", run_mesh, main_path, device)
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        shapes = path("ingest", "6 ingest", run_ingest, work, device, INGEST, args.seed)
        shapes["chunked"] = path("chunked", "12 chunked", run_chunked, work, device,
                                 shapes["run"])
        elsewhere = path("remote", "11 remote", run_remote_ingest, work, device,
                         shapes.pop("run"))
        paths["remote"] = {k: n + elsewhere.get(k, 0) for k, n in paths["remote"].items()}
    path("entry", "7 entry", run_entry, device)
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        phase8 = path("sriracha", "8 sriracha", run_sriracha_phase, work, device, args.seed)
        # Phase 10 keeps to runs A and B.
        path("sriracha_mesh", "10 sriracha mesh", run_sriracha_mesh, work, device,
             {tag: phase8[tag] for tag, *_ in SR_RUNS})
    with tempfile.TemporaryDirectory(prefix="kwage_chip_smoke_") as work:
        shapes["prod_l"] = path("prod_l", "14 prod-L", run_prod_l, work, device, args.seed)
        print("phase 14 counts: " + json.dumps(paths["prod_l"]), flush=True)
    torch.cuda.empty_cache()

    with walls("4 kernels"):
        results = phase_kernels(device, args.seed, shapes)
    driven = {name: names for name, names in PATH_KERNELS.items() if name in paths}
    for name, names in driven.items():
        check(all(paths[name][k] > 0 for k in names),
              f"a kernel of the {name} path was never launched: {paths[name]}")
    print("phase 5 counts: " + "; ".join(
        f"{name} {{{', '.join(f'{k}: {paths[name][k]}' for k in names)}}}"
        for name, names in driven.items()), flush=True)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kwage_tpu"))
    check(not loaded, f"jax or kwage_tpu was imported: {loaded}")
    torch.cuda.empty_cache()
    with walls("13 bench"):
        run_bench(device)
    torch.cuda.empty_cache()
    with walls("15 tools"):
        tools, reports = run_tools(device, deadline)
        tools = collections.Counter(tools) + collections.Counter(scheduler)
        paths["tools"] = {k: tools.get(k, 0) for k in [*REPLACES, *VARIANT_OF]}
        check(all(paths["tools"][k] > 0 for k in PATH_KERNELS["tools"]),
              f"a kernel of the tools path was never launched: {paths['tools']}")
        print("phase 15 counts: " + json.dumps(paths["tools"]), flush=True)
        results.update(variant_checks(device, args.seed, reports["bench.search_phases"]))
    every = [*REPLACES, *VARIANT_OF]
    launches = {k: sum(p.get(k, 0) for p in paths.values()) for k in every}
    check(all(launches[k] > 0 for k in every), f"a kernel was never launched: {launches}")
    print(walls.summary(), flush=True)

    # One line a kernel: its shape on the main path, its time beside its
    # bound there, and its launches on each path.
    for k in every:
        r = results[k]
        print(json.dumps({
            "kernel": k, "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "bytes": r["bytes"],
            "operations": r["operations"], "share_of_bound": r["bound_ms"] / r["ms"],
            "library_ms": r.get("library_ms"),
            **{key: r[key] for key in ("library_all_pairs_ms", "lsd_pass_traffic_ms",
                                       "lsd_pass_operations_ms", "peak_bytes", "sync_ms",
                                       "launch_ms", "own_traffic_ms", "words_route_ms")
               if key in r},
            "launches": {name: counts[k] for name, counts in paths.items() if counts.get(k)}}))
    # The byte entry of bit_transpose: its launches count under that kernel.
    print(json.dumps(results["transpose_bits_device"]))
    print(card)
    # library_ms: compaction + torch.sort twice computes radix_sort_pairs'
    # function on the main path (the valid windows, sorted); no single
    # PyTorch call computes any of the others. gather1 and gather5_and
    # replace no TPU kernel: "replaces" names the JAX phase function.
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES.get(k, VARIANT_SOURCE),
         "replaces": REPLACES.get(k) or VARIANT_OF[k],
         "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
         "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
         "bound_ms": results[k]["bound_ms"], "bound_by": results[k]["bound_by"],
         "library_ms": results[k].get("library_ms")} for k in every]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
