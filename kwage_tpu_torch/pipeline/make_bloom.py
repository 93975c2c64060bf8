"""Per-accession Bloom filter construction (the reference's make_bloom),
host and device (PyTorch + CUDA port of kwage_tpu/pipeline/make_bloom.py).

Host pipeline (make_bloom.cpp:76-504): size the counting filter from the
total base count, stream every read through the counting-Bloom thresholder,
solve the adaptive filter shape from the observed valid-k-mer count, fold
the per-seed valid-bit planes down to the final length, and emit a
``.bloom`` record with crc32 + metadata. These functions (``BuildOptions``,
``BloomInvalid``, ``build_bloom_from_sequences``, ``build_bloom_from_file``,
``DeviceBatchPrep``, ``DeviceScatterState``, ``_src_iter``,
``prepare_device_batch``) are the JAX module's, unchanged.

Device pipeline: exact-count thresholding on the device, as in the JAX
module: canonical k-mers, a sort by (accession, word), the select_runs
kernel, the host solves each filter's shape, and the bloom_set_bits kernel
sets the bits (``kwage_tpu_torch.ops.counting``). An accession above the
batch's chunk_bp is built alone (``build_bloom_device``), from packed
reads to filter image on the card: where the JAX module reads each
chunk's distinct k-mers back and merges them in numpy, the port counts
them with the run_counts kernel and merges them into an accumulator on
the card with the merge_counts kernel.

Two int32 limits of the JAX version are gone: every bit offset is int64,
so filters of 2^31 and 2^32 bits are set on the device (the JAX version
set them on the host), and an L-group of any num_acc * 2^L bits is one
bloom_set_bits launch (the JAX version built each accession of such a
group on its own). The bytes are the same.

Every device function runs on ``resolve_device()`` (``KWAGE_TORCH_DEVICE``,
default ``cuda``).
"""


from __future__ import annotations

import contextlib
import math
import mmap
import threading
import time
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
    COUNT_CAP,
    bloom_set_bits,
    count_kmers_multi_packed,
    filter_words_to_bytes,
    merge_counts,
    run_counts,
    set_filter_bits,
    sort_valid_windows,
)
from ..ops.kmers import canonical_kmers_packed, pack_reads_host
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


# Device memory a window (a row position of a chunk's [rows, blen - k + 1]
# grid) takes at the peak of count_chunk: canonical_kmers' word and flag
# (9 B), the accession key (8), radix_sort_pairs' buffers and look-back
# (about 26 a kept window), run_counts' outputs. Measured with
# torch.cuda.max_memory_allocated by chip_smoke.py phase 12 over a 46 Mbp
# accession's [306666, 160] block (NVIDIA H100 80GB HBM3, 700 W): 38.01 B
# a window with 120 of its 130 windows a row valid, 40.65 B with all of them
# valid and distinct, the most a window takes. The phase fails if a count
# takes more.
BYTES_PER_WINDOW = 41
# Device memory merge_counts takes a word of its two runs: its outputs, a
# word (8 B), a count (4) and a flag (1) for each of na + nb, and its splits
# and look-back (24 B a tile of 4096); 13.02 B measured by phase 12 on the
# same card, which fails if a merge takes more.
MERGE_BYTES_PER_WORD = 14
# The most windows a chunk sized from the card takes: about 5.5 GB at
# BYTES_PER_WINDOW, so that a process sharing the card (a --worker beside
# its coordinator), which _CARD_TURN does not reach, still finds most of it
# free. 2^27 windows are about 155 Mbp of 150 bp reads.
CHUNK_WINDOWS_MAX = 1 << 27
# Without a card (the tests): windows a chunk.
CPU_CHUNK_WINDOWS = 1 << 22
# Host memory: a file's packed block (2 bits of code and 1 valid bit a base,
# 0.375 B, each row padded to the longest read) is held whole up to this
# many bytes, for one build, and page-locked only while that build runs;
# past it the file streams through the Python reader.
PACK_HOST_CAP_BYTES = 8 << 30
# Host memory: a chunk of streamed reads is packed from an ASCII block of at
# most this many (padded) bases.
STRING_CHUNK_BASES = 1 << 26
# One chunk's count and merge, or one build's bit set, at a time in this
# process. Each sizes its work from the memory free when it takes its turn,
# so builds in other threads (the maestro's device workers, the
# coordinator's local workers) cannot spend the same memory between that
# reading and the allocation. Between turns a build holds only its
# accumulator, which the next reading sees as taken.
_CARD_TURN = threading.Lock()
# A chunk of one row whose count or merge still runs out of device memory
# waits for memory another process holds (its own chunk, freed when that
# chunk is merged): at most CARD_WAITS more tries, the first after
# CARD_WAIT_S, each wait twice the last (12.75 s in all), then it raises.
# Halving cannot help there: a merge's output is the accumulator's size.
# A child of chip_smoke.py's phase 12 waited 4 times (0.75 s) on an NVIDIA
# H100 80GB HBM3 at 700 W.
CARD_WAITS = 8
CARD_WAIT_S = 0.05
# This process's out-of-memory retries in the chunk loop since the last
# reset: chunks counted again at half their rows, waits at one row; counted
# under _CARD_TURN.
_RETRIES = {"halved": 0, "waited": 0}


def retry_counts() -> dict[str, int]:
    """This process's out-of-memory retries by kind, as
    ``kernels.launch_counts()`` gives its launches."""
    return dict(_RETRIES)


def reset_retry_counts() -> None:
    for kind in _RETRIES:
        _RETRIES[kind] = 0


def _card_free_bytes(device: torch.device) -> int:
    """Bytes the card can still give this process: free device memory and
    what the caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def _need_card(device: torch.device, need: int, what: str) -> None:
    """Raise torch.cuda.OutOfMemoryError (a RuntimeError) when ``need``
    bytes are not free on the card: the chunk loop retries smaller."""
    if device.type == "cuda" and need > _card_free_bytes(device):
        raise torch.cuda.OutOfMemoryError(
            f"the device build does not fit the card: {what} needs {need} B, "
            f"{_card_free_bytes(device)} B are free")


def _chunk_rows(device: torch.device, row_windows: int) -> int:
    """Rows a chunk takes when the caller gives no chunk_bp, read at the
    chunk's turn: at most CHUNK_WINDOWS_MAX windows and half of what the
    card has free (the other half is its merge's), or CPU_CHUNK_WINDOWS
    without a card."""
    windows = CPU_CHUNK_WINDOWS
    if device.type == "cuda":
        windows = min(CHUNK_WINDOWS_MAX, _card_free_bytes(device) // (2 * BYTES_PER_WINDOW))
    if windows < row_windows:
        raise RuntimeError(f"one row of {row_windows} windows does not fit the card")
    return windows // row_windows


def _row_len(max_len: int, k: int) -> int:
    """Bases a packed row holds: the longest read, to a multiple of 32."""
    return max(32, -(-max(max_len, k) // 32) * 32)


def _pack_file_block(path: str, k: int):
    """A FASTA/FASTQ(.gz) file's reads of >= k bases, 2-bit packed by the
    native parser into one host block, no Python strings: (spots, bp,
    packed int32 [rows, blen/16], valid_words int32 [rows, blen/32], blen,
    the buffer under both, a page-aligned uint32 array of its own pages).
    None when the native library or the format cannot, or the block would
    pass PACK_HOST_CAP_BYTES."""
    from ..io.sequence import FASTQ, UNKNOWN_SEQUENCE, get_file_type
    from ..native import available, pack_file_native, scan_file_batch_native

    ftype = get_file_type(path)
    if not available() or ftype == UNKNOWN_SEQUENCE:
        return None
    fmt = 1 if ftype == FASTQ else 0
    spots, bp, rows, max_len = scan_file_batch_native(path, fmt, k)
    blen = _row_len(max_len, k)
    n16, n32 = rows * (blen // 16), rows * (blen // 32)
    if (n16 + n32) * 4 > PACK_HOST_CAP_BYTES:
        return None
    # An anonymous mapping: zeroed, and no other buffer shares its pages.
    buf = np.frombuffer(mmap.mmap(-1, max(4, (n16 + n32) * 4)), np.uint32)
    packed = buf[:n16].reshape(rows, blen // 16)
    valid_words = buf[n16 : n16 + n32].reshape(rows, blen // 32)
    if rows:
        pack_file_native(path, fmt, k, 0, rows, packed, valid_words)
    return (spots, bp, torch.from_numpy(packed.view(np.int32)),
            torch.from_numpy(valid_words.view(np.int32)), blen, buf)


@contextlib.contextmanager
def _page_locked(buf, device: torch.device):
    """``buf`` (a page-aligned host array) page-locked for the card's copies
    while inside (cudaHostRegister), and let go on exit once this thread's
    stream is done with it; without a card or a buffer, nothing. Not
    PyTorch's pinned allocator, which keeps what it gave out."""
    if buf is None or device.type != "cuda":
        yield
        return
    rt = torch.cuda.cudart()
    err = rt.cudaHostRegister(buf.ctypes.data, buf.nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {buf.nbytes} B failed: error {int(err)}")
    try:
        yield
    finally:
        torch.cuda.current_stream(device).synchronize()
        rt.cudaHostUnregister(buf.ctypes.data)


def _pack_strings(reads: list[str], k: int):
    """Reads of >= k bases -> (packed int32 [R, blen/16], valid_words int32
    [R, blen/32], blen): one ASCII block, one pack_reads_host."""
    blen = _row_len(max(map(len, reads)), k)
    block = np.frombuffer("".join(r.ljust(blen, "\0") for r in reads).encode("ascii"),
                          np.uint8).reshape(len(reads), blen)
    packed, valid_words = pack_reads_host(block)
    return (torch.from_numpy(packed.view(np.int32)),
            torch.from_numpy(valid_words.view(np.int32)), blen)


def _string_chunks(sequences: Iterable[str], k: int, chunk_bp, seen: dict):
    """Packed chunks of streamed reads: chunk_bp bases each, or (chunk_bp
    None) at most STRING_CHUNK_BASES padded bases. Counts every read's bases
    and spots into ``seen``."""
    chunk: list[str] = []
    bases = longest = 0
    for s in sequences:
        seen["spots"] += 1
        seen["bp"] += len(s)
        if len(s) < k:
            continue
        chunk.append(s)
        bases += len(s)
        longest = max(longest, len(s))
        if (bases >= chunk_bp if chunk_bp is not None
                else len(chunk) * _row_len(longest, k) >= STRING_CHUNK_BASES):
            yield _pack_strings(chunk, k)
            chunk, bases, longest = [], 0, 0
    if chunk:
        yield _pack_strings(chunk, k)


def _with_last(items):
    """(item, is_last) for each item."""
    it = iter(items)
    prev = next(it, it)
    while prev is not it:
        item = next(it, it)
        yield prev, item is it
        prev = item


def count_chunk(packed: torch.Tensor, valid_words: torch.Tensor, length: int, k: int,
                cap: int, min_count: int):
    """One chunk of packed reads (host or device) -> run_counts' outputs over
    its valid windows, on the device: canonical_kmers, the sort of the valid
    windows, run_counts (with min_count > 0, the threshold too)."""
    device = resolve_device()
    words, valid = canonical_kmers_packed(packed.to(device, non_blocking=True),
                                          valid_words.to(device, non_blocking=True), k, length)
    acc = torch.where(valid, 0, 1).reshape(-1)
    del valid
    _, words_s = sort_valid_windows(acc, words.reshape(-1), k, 1)
    del acc, words
    return run_counts(words_s, None, cap, min_count)


def build_bloom_device(
    sequences: "Iterable[str] | str",
    opts: BuildOptions,
    info: FilterInfo,
    chunk_bp: int | None = None,
) -> BloomFilterRecord:
    """Device Bloom construction of one accession: exact-count
    thresholding on the card, from packed reads to filter image. A
    FASTA/FASTQ path is packed natively into one host block (page-locked
    while the build runs) and fed in row ranges; reads from an iterable are
    packed a chunk at a time. Each chunk's valid windows are sorted and
    counted (run_counts), and its distinct (word, count) runs merge into a
    sorted accumulator on the card (merge_counts); counts saturate at
    min_kmer_count, all the threshold reads. The last chunk's merge
    thresholds, and bloom_set_bits takes the accumulator and its flags as
    they are. Only scalars (the sort's and the runs' counts) and the image
    (pinned) come back to the host.

    ``chunk_bp``: bases a chunk (the JAX package's 8,000,000 on a 16 GB
    TPU); None sizes each chunk from the card's free memory at its turn
    (``_CARD_TURN``, ``_chunk_rows``), and a 46 Mbp accession is one chunk.
    BloomInvalid past max_kmers distinct k-mers (checked after every chunk,
    as the JAX version does). A chunk whose count or merge runs out of
    device memory (memory another process took after the chunk was sized)
    is retried at half its rows, the accumulator as it was
    (``retry_counts()["halved"]`` counts each); at one row it waits for
    that memory, at most CARD_WAITS times (``"waited"``), then raises
    torch.cuda.OutOfMemoryError (a RuntimeError). Chunk sizes never change
    the record's bytes."""
    device = resolve_device()
    k = opts.kmer_len
    max_kmers = _max_kmers(opts)
    min_count = max(1, opts.min_kmer_count)
    if min_count > COUNT_CAP:
        raise ValueError(f"min_kmer_count {opts.min_kmer_count} > 2^31 - 1")
    seen = {"spots": 0, "bp": 0}
    block = _pack_file_block(sequences, k) if isinstance(sequences, str) else None
    if block is not None:
        seen["spots"], seen["bp"], packed, valid_words, blen, buf = block
        rows = packed.shape[0]
        step = None if chunk_bp is None else max(1, -(-chunk_bp * rows // max(seen["bp"], 1)))
        blocks = [(packed, valid_words, blen, step)]
    else:
        buf = None
        blocks = ((p, v, blen, None if chunk_bp is None else p.shape[0])
                  for p, v, blen in _string_chunks(_src_iter(sequences), k, chunk_bp, seen))

    acc = None   # (words, counts) of the distinct k-mers so far, on the card
    with _page_locked(buf, device):
        for (p, v, length, step), last_block in _with_last(blocks):
            r = 0
            while r < p.shape[0]:
                with _CARD_TURN:
                    n = step or _chunk_rows(device, length - k + 1)
                    waits = 0
                    while True:
                        last = last_block and r + n >= p.shape[0]
                        try:
                            acc, kept, selected = _count_into(
                                acc, p[r : r + n], v[r : r + n], length, k, min_count, last,
                                max_kmers, device)
                            break
                        except torch.cuda.OutOfMemoryError:
                            # Memory that another process took after this
                            # chunk was sized (a --worker beside its
                            # coordinator, which _CARD_TURN does not reach):
                            # the same rows in halves, the accumulator as it
                            # was; at one row, a bounded wait for it.
                            if n > 1:
                                n = (min(n, p.shape[0] - r) + 1) // 2
                                _RETRIES["halved"] += 1
                            elif waits < CARD_WAITS:
                                time.sleep(CARD_WAIT_S * 2 ** waits)
                                waits += 1
                                _RETRIES["waited"] += 1
                            else:
                                raise
                            if device.type == "cuda":
                                torch.cuda.empty_cache()
                r += n
    if acc is None:
        raise BloomInvalid("no reads of length >= k")

    param = _solve_param(opts, kept, max_kmers)
    with _CARD_TURN:
        image = set_filter_bits(acc[0], selected, k, param.num_hash, param.log_2_filter_len)
        bits = filter_words_to_bytes(image, param.log_2_filter_len)
    info.number_of_bases = info.number_of_bases or seen["bp"]
    info.number_of_spots = info.number_of_spots or seen["spots"]
    return _record(param, bits, info)


def _count_into(acc, packed: torch.Tensor, valid_words: torch.Tensor, length: int, k: int,
                min_count: int, last: bool, max_kmers: int, device: torch.device):
    """One chunk counted (count_chunk) and merged into the accumulator
    ``acc`` (merge_counts; the chunk's runs become it when there is none):
    the new accumulator, its kept count and its selected flags (both only
    on the last chunk, which thresholds). BloomInvalid past
    max_kmers distinct k-mers."""
    _need_card(device, packed.shape[0] * (length - k + 1) * BYTES_PER_WINDOW, "a chunk's count")
    out = count_chunk(packed, valid_words, length, k, min_count,
                      min_count if last and acc is None else 0)
    if acc is not None:
        num = int(out[2][0])
        _need_card(device, MERGE_BYTES_PER_WORD * (acc[0].shape[0] + num),
                   f"merging {num} k-mers into {acc[0].shape[0]}")
        out = merge_counts(*acc, out[0][:num], out[1][:num], min_count,
                           min_count if last else 0)
    words, counts, stats, selected = out
    num, kept = stats.tolist()
    if num > max_kmers:
        raise BloomInvalid(f"k-mer count {num} exceeds feasible maximum {max_kmers}")
    return (words[:num], counts[:num]), kept, None if selected is None else selected[:num]


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
    Kernel launches are asynchronous: this returns before they finish, but
    for the sort's count of valid windows (one small copy to the host)."""
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
    assemble the records, and build the big jobs alone (a path is packed
    natively; chunks sized from the card). The big jobs' paths are scanned
    again: prepare_device_batch, the JAX module's, keeps no scan."""
    jobs, results, small = prep.jobs, prep.results, prep.small
    for j in prep.big:
        try:
            results[j] = build_bloom_device(prep.seq_cache.get(j, jobs[j][0]), opts, jobs[j][1])
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
