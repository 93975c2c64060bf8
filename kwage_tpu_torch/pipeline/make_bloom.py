"""Per-accession Bloom filter construction (the reference's make_bloom),
host and device (PyTorch + CUDA port of kwage_tpu/pipeline/make_bloom.py).

Host pipeline (make_bloom.cpp:76-504): size the counting filter from the
total base count, stream every read through the counting-Bloom thresholder,
solve the adaptive filter shape from the observed valid-k-mer count, fold
the per-seed valid-bit planes down to the final length, and emit a
``.bloom`` record with crc32 + metadata. These functions (``BuildOptions``,
``BloomInvalid``, ``build_bloom_from_sequences``, ``build_bloom_from_file``,
``DeviceBatchPrep``, ``DeviceScatterState``, ``_merge_sorted_counts``,
``_pad_reads_to_batch``, ``_src_iter``) are the JAX module's, unchanged.

Device pipeline: exact-count thresholding on the device, as in the JAX
module: canonical k-mers, a sort by (accession, word), the select_runs
kernel, the host solves each filter's shape, and the bloom_set_bits kernel
sets the bits (``kwage_tpu_torch.ops.counting``).

Two int32 limits of the JAX version are gone: every bit offset is int64,
so filters of 2^31 and 2^32 bits are set on the device (the JAX version
set them on the host), and an L-group of any num_acc * 2^L bits is one
bloom_set_bits launch (the JAX version built each accession of such a
group on its own). The bytes are the same.

Every device function runs on ``resolve_device()`` (``KWAGE_TORCH_DEVICE``,
default ``cuda``).
"""


from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from ..core.hash import MURMUR_HASH_32
from ..core.info import FilterInfo
from ..core.params import (
    DEFAULT_FALSE_POSITIVE_PROBABILITY,
    DEFAULT_KMER_LENGTH,
    DEFAULT_MAX_LOG_2_FILTER_LEN,
    DEFAULT_MIN_LOG_2_FILTER_LEN,
    DEFAULT_SRA_MIN_KMER_COUNT,
    BloomParam,
    approximate_max_kmers,
    optimal_bloom_param,
)
from ..io.bloom_file import BloomFilterRecord
from ..io.sequence import iter_sequences
from ..native import CountingBuilder
from ..ops.counting import (
    bloom_set_bits,
    count_kmers,
    count_kmers_multi_packed,
    filter_words_to_bytes,
    set_filter_bits,
)
from ..ops.kmers import pack_reads_host, tensor_to_words_u64, words_u64_to_tensor
from ..ops.search import words_to_tensor
from ..utils.runtime import resolve_device


# Counting-filter sizing constants (make_bloom.cpp:21-25)
MAX_LOG_COUNT_FILTER_LEN = 32
MIN_LOG_COUNT_FILTER_LEN = 18
COUNT_FILTER_FP = 1.0e-2


@dataclass
class BuildOptions:
    kmer_len: int = DEFAULT_KMER_LENGTH
    min_kmer_count: int = DEFAULT_SRA_MIN_KMER_COUNT
    false_positive_probability: float = DEFAULT_FALSE_POSITIVE_PROBABILITY
    min_log_2_filter_len: int = DEFAULT_MIN_LOG_2_FILTER_LEN
    max_log_2_filter_len: int = DEFAULT_MAX_LOG_2_FILTER_LEN
    hash_func: int = MURMUR_HASH_32
    # Counting-filter clamp; tests shrink these to bound memory.
    min_log_2_count_len: int = MIN_LOG_COUNT_FILTER_LEN
    max_log_2_count_len: int = MAX_LOG_COUNT_FILTER_LEN


class BloomInvalid(Exception):
    """Raised when no valid Bloom parameters exist for an accession
    (maps to STATUS_BLOOM_INVALID)."""


def counting_filter_log2_len(num_bp: int, opts: BuildOptions) -> int:
    """Counting-filter sizing from the total base count (make_bloom.cpp:109-129).

    Two 4-bit counting sub-filters, two hash functions each; length chosen
    so the 4-probe false-positive rate stays under COUNT_FILTER_FP for
    2*num_bp insertions, clamped to the allowed range.
    """
    if num_bp <= 0:
        return opts.max_log_2_count_len
    counting_length = 1.0 / (
        1.0 - (1.0 - COUNT_FILTER_FP ** 0.25) ** (1.0 / (2.0 * num_bp))
    )
    log2_len = math.ceil(math.log(counting_length) / math.log(2.0))
    return max(opts.min_log_2_count_len, min(opts.max_log_2_count_len, log2_len))


def build_bloom_from_sequences(
    sequences: Iterable[str],
    opts: BuildOptions,
    info: FilterInfo,
    num_bp_hint: int | None = None,
) -> BloomFilterRecord:
    """Build a Bloom filter from an in-memory iterable of read sequences.

    ``num_bp_hint`` plays the role of the SRA metadata BASE_COUNT used to
    pre-size the counting filter; when absent the sequences are buffered to
    measure it (matching what the reference gets from sra_meta.cpp).
    """
    if num_bp_hint is None:
        sequences = list(sequences)
        num_bp_hint = sum(len(s) for s in sequences)

    log2_count = counting_filter_log2_len(num_bp_hint, opts)
    max_kmers = approximate_max_kmers(
        opts.false_positive_probability,
        opts.hash_func,
        opts.min_log_2_filter_len,
        opts.max_log_2_filter_len,
    )

    with CountingBuilder(
        opts.kmer_len, opts.min_kmer_count, log2_count, opts.max_log_2_filter_len
    ) as builder:
        for seq in sequences:
            builder.add_sequence(seq)
            if builder.num_valid_kmer > max_kmers:
                raise BloomInvalid(
                    f"k-mer count {builder.num_valid_kmer} exceeds feasible maximum {max_kmers}"
                )
        return _finish_build(builder, opts, info, max_kmers)


def _finish_build(builder, opts: BuildOptions, info: FilterInfo, max_kmers: int) -> BloomFilterRecord:
    """Solve the adaptive shape from the observed count and fold the planes."""
    if builder.num_valid_kmer > max_kmers:
        raise BloomInvalid(
            f"k-mer count {builder.num_valid_kmer} exceeds feasible maximum {max_kmers}"
        )
    try:
        param = optimal_bloom_param(
            opts.kmer_len,
            builder.num_valid_kmer,
            opts.false_positive_probability,
            opts.hash_func,
            opts.min_log_2_filter_len,
            opts.max_log_2_filter_len,
        )
    except ValueError as e:
        raise BloomInvalid(str(e)) from e

    bits = builder.fold(param.log_2_filter_len, param.num_hash)
    return BloomFilterRecord(
        param=param,
        crc32=zlib.crc32(bits.tobytes()) & 0xFFFFFFFF,
        info=info,
        bits=bits,
    )


def _pad_reads_to_batch(sequences: list[str], k: int) -> "np.ndarray":
    """ASCII read batch padded with zeros (invalid windows) to bucketed
    dimensions. BOTH axes bucket -- length to 128-multiples, row count to
    powers of two -- because every distinct shape is a separate XLA
    compile; zero rows contribute no valid windows."""
    max_len = max((len(s) for s in sequences), default=k)
    bucket = max(128, ((max_len + 127) // 128) * 128)
    rows = max(64, 1 << int(np.ceil(np.log2(max(len(sequences), 1)))))
    batch = np.zeros((rows, bucket), dtype=np.uint8)
    for i, s in enumerate(sequences):
        batch[i, : len(s)] = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    return batch


def _merge_sorted_counts(
    words_a: "np.ndarray", counts_a: "np.ndarray",
    words_b: "np.ndarray", counts_b: "np.ndarray",
) -> tuple["np.ndarray", "np.ndarray"]:
    """Merge two sorted (unique word, count) runs into one (host, vectorized)."""
    words = np.concatenate([words_a, words_b])
    counts = np.concatenate([counts_a, counts_b])
    order = np.argsort(words, kind="stable")
    words = words[order]
    counts = counts[order]
    is_start = np.empty(words.shape[0], dtype=bool)
    is_start[0] = True
    np.not_equal(words[1:], words[:-1], out=is_start[1:])
    seg = np.cumsum(is_start) - 1
    merged_counts = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
    np.add.at(merged_counts, seg, counts)
    return words[is_start], merged_counts


def _max_kmers(opts: BuildOptions) -> int:
    return approximate_max_kmers(
        opts.false_positive_probability, opts.hash_func,
        opts.min_log_2_filter_len, opts.max_log_2_filter_len)


def _solve_param(opts: BuildOptions, num_valid: int, max_kmers: int):
    """The adaptive filter shape for num_valid thresholded k-mers, or
    BloomInvalid (bloom.cpp:10-121, with the approximate_max_kmers abort)."""
    if num_valid > max_kmers:
        raise BloomInvalid(f"k-mer count {num_valid} exceeds feasible maximum {max_kmers}")
    try:
        return optimal_bloom_param(
            opts.kmer_len, num_valid, opts.false_positive_probability, opts.hash_func,
            opts.min_log_2_filter_len, opts.max_log_2_filter_len)
    except ValueError as e:
        raise BloomInvalid(str(e)) from e


def _record(param, bits: np.ndarray, info: FilterInfo) -> BloomFilterRecord:
    return BloomFilterRecord(param=param, crc32=zlib.crc32(bits.tobytes()) & 0xFFFFFFFF,
                             info=info, bits=bits)


def build_bloom_device(
    sequences: Iterable[str],
    opts: BuildOptions,
    info: FilterInfo,
    chunk_bp: int = 8_000_000,
) -> BloomFilterRecord:
    """Device Bloom construction of one accession: exact-count
    thresholding, streamed in ~chunk_bp-base chunks. Each chunk is
    k-merized, sorted and counted on the device; its distinct (word,
    count) runs merge on the host (KMC-style external counting: RAM
    bounded by the distinct-k-mer set, device memory by the chunk). The
    bits of the thresholded words are set on the device at every L."""
    device = resolve_device()
    k = opts.kmer_len
    num_bp = num_spots = 0
    acc_words = np.empty(0, dtype=np.uint64)
    acc_counts = np.empty(0, dtype=np.int64)
    max_kmers = _max_kmers(opts)

    def digest(chunk: list[str]) -> None:
        nonlocal acc_words, acc_counts
        # min_count=1 here: per-chunk counts must stay exact for the merge.
        words_s, selected, _, num_windows = count_kmers(
            _pad_reads_to_batch(chunk, k), k, 1, device)
        starts = torch.nonzero(selected).reshape(-1)
        if starts.numel() == 0:
            return
        words = tensor_to_words_u64(words_s[starts])
        # Each sorted run ends at the next start; the last one where the
        # valid prefix ends (invalid windows sort last).
        starts = starts.cpu().numpy()
        counts = np.append(starts[1:], num_windows) - starts
        if acc_words.size:
            acc_words, acc_counts = _merge_sorted_counts(acc_words, acc_counts, words, counts)
        else:
            acc_words, acc_counts = words, counts.astype(np.int64)
        if acc_words.size > max_kmers:
            raise BloomInvalid(f"k-mer count {acc_words.size} exceeds feasible maximum {max_kmers}")

    chunk: list[str] = []
    chunk_bases = 0
    any_long_read = False
    for s in sequences:
        num_spots += 1
        num_bp += len(s)
        if len(s) < k:
            continue
        any_long_read = True
        chunk.append(s)
        chunk_bases += len(s)
        if chunk_bases >= chunk_bp:
            digest(chunk)
            chunk, chunk_bases = [], 0
    if chunk:
        digest(chunk)
    if not any_long_read:
        raise BloomInvalid("no reads of length >= k")

    thresholded = acc_words[acc_counts >= opts.min_kmer_count]
    param = _solve_param(opts, int(thresholded.size), max_kmers)
    words = words_u64_to_tensor(thresholded, device)
    packed = set_filter_bits(words, torch.ones(words.shape, dtype=torch.bool, device=device),
                             k, param.num_hash, param.log_2_filter_len)
    info.number_of_bases = info.number_of_bases or num_bp
    info.number_of_spots = info.number_of_spots or num_spots
    return _record(param, filter_words_to_bytes(packed, param.log_2_filter_len), info)


@dataclass
class DeviceBatchPrep:
    """Host-side output of prepare_device_batch: everything the device
    phase needs, with zero device work done yet. Lets a dispatcher
    thread overlap the (native, GIL-released) parse/pack of batch i+1
    with the in-flight device compute of batch i."""

    jobs: list
    results: list                     # pre-filled big-job/empty slots... (None = pending)
    small: list                       # job indices in the fused block
    big: list                         # job indices routed to the chunked builder
    bp_spots: dict
    no_long_read: set
    packed: "np.ndarray | None"       # [rows_bucket, blen/16] uint32
    valid_words: "np.ndarray | None"
    acc_ids: "np.ndarray | None"
    blen: int = 0
    seq_cache: dict = None  # type: ignore[assignment]
    chunk_bp: int = 8_000_000


def _src_iter(src):
    if isinstance(src, str):
        from ..io.sequence import iter_sequences

        return (q for _, q in iter_sequences(src))
    return iter(src)


def prepare_device_batch(
    jobs: list[tuple[list[str], FilterInfo]],
    opts: BuildOptions,
    chunk_bp: int = 8_000_000,
) -> DeviceBatchPrep:
    """Host phase of the batched device build: scan every source, route
    oversized jobs to the chunked builder, and 2-bit-pack the rest into
    one padded block (native kn_scan_file/kn_pack_file for paths -- zero
    Python strings). Pure host work: safe to run in a parse thread while
    the device executes another batch. The JAX module's function, with
    this package's ``pack_reads_host``."""
    from ..io.sequence import FASTQ, UNKNOWN_SEQUENCE, get_file_type
    from ..native import (
        available as native_available,
        pack_file_native,
        scan_file_batch_native,
    )

    def _native_path(src) -> bool:
        return (isinstance(src, str) and native_available()
                and get_file_type(src) != UNKNOWN_SEQUENCE)

    k = opts.kmer_len
    results: list = [None] * len(jobs)

    # Scan every job: (bp, spots, long-read rows, max long-read length).
    scans: dict[int, tuple[int, int, int, int]] = {}
    seq_cache: dict[int, list[str]] = {}
    small: list[int] = []
    big: list[int] = []
    for j, (src, _info) in enumerate(jobs):
        if _native_path(src):
            fmt = 1 if get_file_type(src) == FASTQ else 0
            spots, bp, rows, max_len = scan_file_batch_native(src, fmt, k)
        else:
            seqs = src if isinstance(src, list) else list(_src_iter(src))
            seq_cache[j] = seqs
            spots, bp = len(seqs), sum(len(x) for x in seqs)
            longs = [len(x) for x in seqs if len(x) >= k]
            rows, max_len = len(longs), max(longs, default=0)
        scans[j] = (bp, spots, rows, max_len)
        (big if bp > chunk_bp else small).append(j)

    prep = DeviceBatchPrep(
        jobs=jobs, results=results, small=small, big=big, bp_spots={},
        no_long_read=set(), packed=None, valid_words=None, acc_ids=None,
        seq_cache=seq_cache, chunk_bp=chunk_bp,
    )
    if not small:
        return prep

    # One padded packed block for the whole batch. Slot s = job small[s].
    live: list[int] = []  # slots with rows
    total_rows = 0
    max_len = k
    for s, j in enumerate(small):
        bp, spots, rows, mlen = scans[j]
        prep.bp_spots[j] = (bp, spots)
        if rows == 0:
            prep.no_long_read.add(j)
            results[j] = BloomInvalid("no reads of length >= k")
            continue
        live.append(s)
        total_rows += rows
        max_len = max(max_len, mlen)
    if total_rows == 0:
        return prep

    # The JAX module's buckets: 128-multiples of length, pow2 rows.
    blen = max(128, -(-max_len // 128) * 128)
    rows_bucket = max(64, 1 << int(np.ceil(np.log2(total_rows))))
    w16, w32 = blen // 16, blen // 32
    packed = np.zeros((rows_bucket, w16), dtype=np.uint32)
    valid_words = np.zeros((rows_bucket, w32), dtype=np.uint32)
    acc_ids = np.zeros(rows_bucket, dtype=np.int32)
    row = 0
    for s in live:
        j = small[s]
        src = jobs[j][0]
        if j in seq_cache or not _native_path(src):
            seqs = seq_cache.get(j) or list(_src_iter(src))
            longs = [x for x in seqs if len(x) >= k]
            block = np.zeros((len(longs), blen), dtype=np.uint8)
            for i, x in enumerate(longs):
                block[i, : len(x)] = np.frombuffer(x.encode("ascii"), np.uint8)
            p, v = pack_reads_host(block)
            n = len(longs)
            packed[row : row + n] = p
            valid_words[row : row + n] = v
        else:
            fmt = 1 if get_file_type(src) == FASTQ else 0
            n = pack_file_native(src, fmt, k, row, scans[j][2], packed, valid_words)
        acc_ids[row : row + n] = s
        row += n
    prep.packed, prep.valid_words, prep.acc_ids = packed, valid_words, acc_ids
    prep.blen = blen
    return prep


def dispatch_device_batch(prep: DeviceBatchPrep, opts: BuildOptions):
    """Upload the packed block and run the fused count: canonical_kmers,
    the sort, select_runs. Returns device tensors (acc_s, words_s,
    selected, num_valid), or None when the batch has no fused rows.
    Kernel launches are asynchronous: this returns before they finish."""
    if prep.packed is None:
        return None
    device = resolve_device()
    return count_kmers_multi_packed(
        words_to_tensor(prep.packed, device), words_to_tensor(prep.valid_words, device),
        torch.from_numpy(prep.acc_ids).to(device),
        opts.kmer_len, opts.min_kmer_count, len(prep.small), prep.blen)


@dataclass
class DeviceScatterState:
    """Output of scatter_device_batch: per-group device filter images
    (host transfer already started async) plus the solved params."""

    params: dict              # slot -> BloomParam
    scatters: list            # (h_slots, device packed filter words)
    fallback_slots: list      # slots routed to the per-accession builder


def scatter_device_batch(prep: DeviceBatchPrep, opts: BuildOptions, handles):
    """Middle device phase: read back the per-accession counts, solve
    each accession's BloomParam, launch one bloom_set_bits per (L,
    num_hash) group and START each image's copy to a pinned host buffer
    (``non_blocking``, with a CUDA event that complete_device_batch waits
    on). Returns right after the launches, so the caller can overlap the
    copies with the next batch's count. ``scatters`` holds (slots, host
    image, event or None)."""
    results, small = prep.results, prep.small
    state = DeviceScatterState(params={}, scatters=[], fallback_slots=[])
    if prep.packed is None:
        return state
    acc_s, words_s, selected, num_valid = handles
    num_valid = num_valid.cpu().numpy()
    num_acc = len(small)
    max_kmers = _max_kmers(opts)

    # Host: per-accession adaptive sizing; group accessions by chosen L.
    groups: dict[int, list[int]] = {}  # log2_filter_len -> slots
    for s, j in enumerate(small):
        if j in prep.no_long_read:
            continue
        try:
            p = _solve_param(opts, int(num_valid[s]), max_kmers)
        except BloomInvalid as e:
            results[j] = e
            continue
        state.params[s] = p
        groups.setdefault(p.log_2_filter_len, []).append(s)

    device = acc_s.device
    for log2_L, slots in sorted(groups.items()):
        # num_hash may differ within an L-group; one launch per num_hash.
        by_h: dict[int, list[int]] = {}
        for s in slots:
            by_h.setdefault(state.params[s].num_hash, []).append(s)
        for nh, h_slots in sorted(by_h.items()):
            slot_of_acc = np.full(num_acc + 1, -1, dtype=np.int32)
            slot_of_acc[h_slots] = h_slots
            image = bloom_set_bits(acc_s, words_s, selected,
                                   torch.from_numpy(slot_of_acc).to(device),
                                   opts.kmer_len, nh, log2_L)
            event = None
            if image.device.type == "cuda":
                host = torch.empty(image.shape, dtype=image.dtype, pin_memory=True)
                host.copy_(image, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(image.device))
                image = host
            state.scatters.append((h_slots, image, event))
    return state


def complete_device_batch(prep: DeviceBatchPrep, opts: BuildOptions,
                          state: DeviceScatterState) -> list:
    """Final phase: wait for the (already in-flight) image copies,
    assemble the records, and build the chunked big jobs."""
    jobs, results, small = prep.jobs, prep.results, prep.small
    for j in prep.big:
        try:
            results[j] = build_bloom_device(
                _src_iter(prep.seq_cache.get(j, jobs[j][0])), opts, jobs[j][1], prep.chunk_bp)
        except Exception as e:  # noqa: BLE001 -- per-job fault isolation
            results[j] = e

    for h_slots, image, event in state.scatters:
        if event is not None:
            event.synchronize()
        packed = image.numpy()
        for s in h_slots:
            j = small[s]
            param = state.params[s]
            info = jobs[j][1]
            num_bp, num_spots = prep.bp_spots[j]
            info.number_of_bases = info.number_of_bases or num_bp
            info.number_of_spots = info.number_of_spots or num_spots
            results[j] = _record(param, filter_words_to_bytes(packed[s], param.log_2_filter_len),
                                 info)
    return results


def finish_device_batch(prep: DeviceBatchPrep, opts: BuildOptions, handles=None) -> list:
    """Device phase tail: scatter + complete back to back (the
    non-pipelined path)."""
    if prep.packed is not None and handles is None:
        handles = dispatch_device_batch(prep, opts)
    state = scatter_device_batch(prep, opts, handles)
    return complete_device_batch(prep, opts, state)


def build_blooms_device_batch(
    jobs: list[tuple[list[str], FilterInfo]],
    opts: BuildOptions,
    chunk_bp: int = 8_000_000,
) -> list:
    """Batched device Bloom construction: many accessions per dispatch.

    One fused count (a sort by (accession, word) over 2-bit host-packed
    reads; only the per-accession counts come back to the host), the host
    solves each accession's BloomParam, then one bloom_set_bits per (L,
    num_hash) group builds every filter image and the images come back
    together. Returns one entry per job: a BloomFilterRecord, or the
    Exception the job raised (BloomInvalid for infeasible sizing). Jobs
    larger than chunk_bp go to the chunked single-accession builder. A
    source may be a list of sequences or a FASTA/FASTQ(.gz) path."""
    return finish_device_batch(prepare_device_batch(jobs, opts, chunk_bp), opts)


def build_bloom_from_file(
    path: str, opts: BuildOptions, info: FilterInfo | None = None
) -> BloomFilterRecord:
    """Build a Bloom filter from a FASTA/FASTQ(.gz) file (two streaming passes).

    Pass 1 measures the base/spot counts (the metadata the reference reads
    from the SRA record); pass 2 digests the reads. Both passes run fully
    in native code when the library is available (parser + counting loop,
    no Python per read); the Python reader is the fallback and the oracle.
    """
    from ..io.sequence import FASTA, FASTQ, get_file_type
    from ..native import available as native_available, scan_file_native

    if info is None:
        info = FilterInfo()

    ftype = get_file_type(path)
    use_native = native_available() and ftype in (FASTA, FASTQ)

    if use_native:
        num_spots, num_bp = scan_file_native(path, ftype)
    else:
        num_bp = 0
        num_spots = 0
        for _, seq in iter_sequences(path):
            num_bp += len(seq)
            num_spots += 1

    # Inventory metadata counts flow through unchanged like the reference
    # (make_bloom.cpp never writes measured counts into FilterInfo);
    # measured values only fill absent metadata.
    info.number_of_bases = info.number_of_bases or num_bp
    info.number_of_spots = info.number_of_spots or num_spots

    if not use_native:
        return build_bloom_from_sequences(
            (seq for _, seq in iter_sequences(path)), opts, info, num_bp_hint=num_bp
        )

    log2_count = counting_filter_log2_len(num_bp, opts)
    max_kmers = approximate_max_kmers(
        opts.false_positive_probability,
        opts.hash_func,
        opts.min_log_2_filter_len,
        opts.max_log_2_filter_len,
    )
    with CountingBuilder(
        opts.kmer_len, opts.min_kmer_count, log2_count, opts.max_log_2_filter_len
    ) as builder:
        builder.digest_file(path, ftype)
        return _finish_build(builder, opts, info, max_kmers)
