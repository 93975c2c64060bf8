"""Bit-sliced Bloom-filter search (host path; device kernel in ops.search).

Per query (kwage.cpp:340-541): extract the sorted unique canonical k-mer
set, map each (k-mer, seed) pair to a bit-slice row via murmur3-32 %% 2**L,
AND the gathered slice rows across seeds into per-k-mer match vectors, then
either AND across k-mers (threshold == 1.0, "complete match") or count hits
per filter and compare against ``trunc(float32(threshold) * num_kmers)``
(the reference's float->uint narrowing, kwage.cpp:388).

The reference's early-exit logic is a disk-seek optimization and never
changes results; the vectorized full reduction used here is faster on
modern hardware and identical in output.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.info import FilterInfo
from ..core.words import canonical_kmers
from ..io.db_file import DBFileReader
from ..native import (
    murmur32_native,
    read_profile_native,
    search_all_native,
    search_native,
)


@dataclass
class MatchResult:
    num_kmers_found: int
    num_query_kmer: int
    subject_info: FilterInfo


def query_slice_indices(query: str, header) -> tuple[np.ndarray, int]:
    """Sorted-unique query k-mers -> slice row indices [n_kmer, num_hash]."""
    profile = read_profile_native(query, header.kmer_len)
    if profile is not None:
        # Native extraction+dedup (~12x the numpy formulation per query);
        # the scratch view is consumed by the murmur call below.
        _, kmers = profile
    else:
        kmers = np.unique(canonical_kmers(query, header.kmer_len))
    if kmers.size == 0:
        return np.empty((0, header.num_hash), dtype=np.int64), 0
    h = murmur32_native(kmers, header.kmer_len, header.num_hash)
    if header.log_2_filter_len >= 32:
        idx = h.astype(np.int64)
    else:
        idx = (h & np.uint32((1 << header.log_2_filter_len) - 1)).astype(np.int64)
    return idx, int(kmers.size)


def query_threshold_count(threshold: float, num_query_kmer: int) -> int:
    """trunc(float32(threshold) * float32(num_kmers)) (kwage.cpp:388)."""
    return int(np.float32(threshold) * np.float32(num_query_kmer))


def _match_filters(
    slice_rows: np.ndarray, num_hash: int, num_filter: int, threshold: float
) -> tuple[np.ndarray, np.ndarray]:
    """Reduce gathered slice rows into (matched_mask, per-filter counts).

    ``slice_rows``: uint8 [n_kmer * num_hash, slice_size].
    """
    n_total = slice_rows.shape[0]
    n_kmer = n_total // num_hash
    rows = slice_rows.reshape(n_kmer, num_hash, -1)
    kmer_match = rows[:, 0, :]
    for h in range(1, num_hash):
        kmer_match = kmer_match & rows[:, h, :]

    bits = np.unpackbits(kmer_match, axis=1, bitorder="little")[:, :num_filter]
    counts = bits.sum(axis=0, dtype=np.int64)
    if threshold == 1.0:
        matched = bits.all(axis=0) if n_kmer else np.zeros(num_filter, dtype=bool)
    else:
        qt = query_threshold_count(threshold, n_kmer)
        matched = counts >= qt
    return matched, counts


def search_database(
    reader: DBFileReader,
    query: str,
    threshold: float,
    slices: np.ndarray | None = None,
) -> list[tuple[int, int, int]] | None:
    """Search one database file with one query.

    Returns ``[(filter_index, num_kmers_found, num_query_kmer), ...]`` for
    matching filters in filter-index order, or None when the query has no
    valid k-mers. ``slices`` optionally supplies the full in-memory slice
    matrix (uint8 [filter_len, slice_size]) to avoid per-row disk seeks.
    """
    hdr = reader.header
    idx, n_kmer = query_slice_indices(query, hdr)
    if n_kmer == 0:
        return None

    flat = idx.reshape(-1)
    if slices is not None:
        matrix, matrix_idx = slices, flat
    else:
        # Gather unique rows once; the reference re-reads per (kmer, seed).
        uniq, inverse = np.unique(flat, return_inverse=True)
        matrix, matrix_idx = reader.read_slice_rows(uniq), inverse

    # Native kernel: zero-copy row gather + early-exit AND (complete) or
    # carry-save bit-plane counts (thresholded); numpy full reduction is
    # the fallback twin. Identical output either way.
    qt = 0 if threshold == 1.0 else query_threshold_count(threshold, n_kmer)
    hits = search_native(
        matrix, matrix_idx, hdr.num_hash, hdr.num_filter, threshold, qt)
    if hits is not None:
        return [(fidx, count, n_kmer) for fidx, count in hits]

    rows = matrix[matrix_idx]
    matched, counts = _match_filters(rows, hdr.num_hash, hdr.num_filter, threshold)

    out = []
    for i in np.nonzero(matched)[0]:
        num_match = n_kmer if threshold == 1.0 else int(counts[i])
        out.append((int(i), num_match, n_kmer))
    return out


def search_database_files(
    db_paths: list[str],
    queries: list[tuple[int, str]],
    threshold: float,
    in_memory: bool = True,
    num_threads: int | None = None,
) -> dict[int, list[MatchResult]]:
    """Search every query against every database file.

    ``queries`` is a list of (query_id, sequence). Results are accumulated
    per query id in (file order, filter index order) and then stable-sorted
    descending by num_kmers_found, reproducing the reference's output order
    (output.h:27-32; kwage.cpp:190-201).

    Files search concurrently like the reference's OpenMP loop
    (kwage.cpp:76-87) -- numpy releases the GIL -- but per-file results
    merge in file order, so the output is deterministic regardless of
    thread count.
    """
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from ..io.dbz_file import open_database

    # Encode the query batch once; every per-file batched search reuses it.
    encoded_queries = [
        seq.encode("ascii", errors="replace") for _, seq in queries]

    def search_one(path: str) -> dict[int, list[MatchResult]]:
        per_file: dict[int, list[MatchResult]] = {}
        reader = open_database(path)
        if in_memory and hasattr(reader, "mmap_slices"):
            # Lazy view: only the rows a query touches fault in from disk,
            # so a complete-match early exit reads a few pages, not the
            # whole file (the reference's seek behavior, kwage.cpp:415-424).
            # in_memory=False keeps the explicit per-row seek gather live
            # (the only path for compressed readers, and its parity test).
            slices = reader.mmap_slices()
        else:
            slices = reader.read_slices() if in_memory else None
        infos_cache: dict[int, FilterInfo] = {}
        hdr = reader.header
        batched = None
        if slices is not None:
            # One native call for the whole query batch: extraction,
            # hashing, gather and reduction all in C (identical output to
            # the per-query path; per-query Python/ctypes overhead gone).
            batched = search_all_native(
                slices, encoded_queries, hdr.kmer_len,
                hdr.num_hash, hdr.log_2_filter_len, hdr.num_filter,
                threshold)
        for qpos, (qid, seq) in enumerate(queries):
            if batched is not None:
                hits = batched[qpos]
            else:
                hits = search_database(reader, seq, threshold, slices=slices)
            if not hits:
                continue
            bucket = per_file.setdefault(qid, [])
            for fidx, num_match, n_kmer in hits:
                info = infos_cache.get(fidx)
                if info is None:
                    info = reader.read_filter_info(fidx)
                    infos_cache[fidx] = info
                bucket.append(MatchResult(num_match, n_kmer, info))
        return per_file

    if num_threads is None:
        # Each in-memory worker holds one full slice matrix, so the default
        # caps residency at ~4 files' worth. KWAGE_NUM_THREADS overrides;
        # OMP_NUM_THREADS is honored for drop-in parity with the
        # reference's OpenMP file loop (kwage.cpp:76-87).
        env = _os.environ.get("KWAGE_NUM_THREADS") or _os.environ.get("OMP_NUM_THREADS")
        cap = int(env) if env else min(4, _os.cpu_count() or 1)
        num_threads = min(cap, max(1, len(db_paths)))
    if num_threads <= 1 or len(db_paths) <= 1:
        per_file_results = [search_one(p) for p in db_paths]
    else:
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            per_file_results = list(pool.map(search_one, db_paths))

    results: dict[int, list[MatchResult]] = {}
    for per_file in per_file_results:  # file order preserved
        for qid, bucket in per_file.items():
            results.setdefault(qid, []).extend(bucket)

    for bucket in results.values():
        bucket.sort(key=lambda m: -m.num_kmers_found)
    return results
