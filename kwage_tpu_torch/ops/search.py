"""Device bit-slice search (PyTorch + CUDA port of kwage_tpu/ops/search.py).

The database lives on the device as an int32 tensor ``[filter_len, W]``
holding the uint32 signature words (``W = ceil(num_filter / 32)``; bit j
of filter j at word j//32, bit j%32 -- the little-endian view of the
on-disk bytes). Per query batch, both reductions gather the ``num_hash``
slice rows of each k-mer and AND them across seeds, then:

- threshold == 1.0: AND across k-mers (padding k-mers count as all-ones)
  -> packed complete-match mask ``[nq, W]`` (``search_complete``);
- threshold < 1: per-filter hit counts ``[nq, W*32]`` (padding k-mers
  add zero) (``search_counts``).

``search_total_hits`` is the second one carried to the end: the number of
bit columns whose count reaches a per-query threshold, int32 ``[nq]``, with
the counts kept out of device memory (one column shard's share of the mesh
path's corpus totals, ``parallel.sharded_search``).

Each wrapper launches its CUDA kernel (``csrc/search.cu``) on a CUDA
tensor and runs its plain PyTorch version (``complete_ref`` /
``counts_ref`` / ``total_hits_ref``) on a CPU tensor. The fusion, slab and ordering rules of
the JAX module are kept, so hit lists stay identical to the host engine.
Where the JAX module uploads every row of a host chunk, the multi-file
search uploads only the rows a query batch touches when they are few
(``search_chunk``'s gather route), and streams a chunk past its budget
in column slabs staged ahead on reader threads (``eval_chunk_cols``).
"""

from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import kernels
from ..core.words import canonical_kmers
from ..native import murmur32_native

DEFAULT_FUSION_BUDGET_BYTES = 8 << 30
# Slice rows are int32 on the card (``make_query_batch``, the kernels'
# idx), so a file at L = 32 has rows the device search cannot address.
MAX_DEVICE_LOG2_LEN = 31


def fusion_budget_bytes() -> int:
    """Bytes of fused matrix per device chunk (KWAGE_FUSION_BUDGET_BYTES)."""
    return int(os.environ.get("KWAGE_FUSION_BUDGET_BYTES", DEFAULT_FUSION_BUDGET_BYTES))


def check_device_filter_len(readers) -> None:
    """Refuse, from the headers alone (before any slice is read or
    uploaded), a database file whose filter length the device search
    cannot index: L > MAX_DEVICE_LOG2_LEN. The host engine searches it."""
    for r in readers:
        L = r.header.log_2_filter_len
        if L > MAX_DEVICE_LOG2_LEN:
            raise ValueError(
                f"{r.path}: L={L}; the device search indexes slice rows as int32 and takes "
                f"L <= {MAX_DEVICE_LOG2_LEN}: search this file with the host engine "
                "(kwage-torch without --device)")


# --- host helpers (numpy; the JAX module's twins) ---------------------------

def db_bytes_to_words(slices: np.ndarray) -> np.ndarray:
    """Disk slice matrix uint8 [L, slice_size] -> uint32 [L, W] (host)."""
    L, B = slices.shape
    pad = (-B) % 4
    if pad:
        slices = np.pad(slices, ((0, 0), (0, pad)))
    return np.ascontiguousarray(slices).reshape(L, -1, 4).view(np.uint32).reshape(L, -1)


def make_query_batch(
    queries: list[str], k: int, num_hash: int, log2_filter_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side query prep: pad per-query sorted-unique k-mer slice indices.

    Returns (idx int32 [nq, max_k, num_hash], kmer_valid bool [nq, max_k],
    num_kmers int32 [nq]); the k-mer axis is a multiple of 128 (>= 128).
    """
    mask = np.uint32((1 << log2_filter_len) - 1) if log2_filter_len < 32 else np.uint32(0xFFFFFFFF)
    per_query = []
    for q in queries:
        kmers = np.unique(canonical_kmers(q, k))
        per_query.append((murmur32_native(kmers, k, num_hash) & mask).astype(np.int64))
    nq = len(per_query)
    max_k = max((p.shape[0] for p in per_query), default=0)
    max_k = max(128, ((max_k + 127) // 128) * 128)
    idx = np.zeros((nq, max_k, num_hash), dtype=np.int32)
    valid = np.zeros((nq, max_k), dtype=bool)
    nk = np.zeros(nq, dtype=np.int32)
    for i, p in enumerate(per_query):
        idx[i, : p.shape[0]] = p
        valid[i, : p.shape[0]] = True
        nk[i] = p.shape[0]
    return idx, valid, nk


def unpack_mask(mask_words: np.ndarray, num_filter: int) -> np.ndarray:
    """Packed uint32 match mask [nq, W] -> bool [nq, num_filter] (host)."""
    m = np.ascontiguousarray(mask_words)
    bits = np.unpackbits(m.view(np.uint8).reshape(m.shape[0], -1), axis=1, bitorder="little")
    return bits[:, :num_filter].astype(bool)


def words_to_tensor(words_u32: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 numpy matrix -> int32 tensor of the same bits on ``device``.
    This is how a signature matrix (the JAX package's ``np.asarray(db)``
    or ``db_bytes_to_words(...)``) enters the port."""
    arr = np.ascontiguousarray(words_u32).view(np.int32)
    if not arr.flags.writeable:  # torch.from_numpy wants writable memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of uint32 bit patterns -> uint32 numpy array (host)."""
    return np.ascontiguousarray(t.cpu().numpy()).view(np.uint32)


# --- plain PyTorch versions -------------------------------------------------

def _seed_and(db: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-k-mer match words int32 [nq, nk, W]: AND of the nh gathered rows."""
    nq, nk, nh = idx.shape
    flat = idx.reshape(nq * nk, nh).long()
    km = db.index_select(0, flat[:, 0])
    for h in range(1, nh):
        km &= db.index_select(0, flat[:, h])
    return km.reshape(nq, nk, db.shape[1])


def complete_ref(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain complete match: int32 [nq, W]; AND over valid k-mers (a
    pairwise tree over the k-mer axis -- torch has no AND reduction)."""
    km = _seed_and(db, idx)
    km = torch.where(valid[:, :, None], km, torch.full_like(km, -1))  # -1 == 0xFFFFFFFF
    while km.shape[1] > 1:
        half = km.shape[1] // 2
        folded = km[:, :half] & km[:, half : 2 * half]
        km = torch.cat([folded, km[:, 2 * half :]], dim=1) if km.shape[1] % 2 else folded
    if km.shape[1] == 0:
        return torch.full((idx.shape[0], db.shape[1]), -1, dtype=torch.int32, device=db.device)
    return km[:, 0].contiguous()


def counts_ref(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain hit counts: int32 [nq, W*32], out[q, 32w+b] = number of valid
    k-mers whose match word w has bit b set."""
    km = _seed_and(db, idx)
    km = torch.where(valid[:, :, None], km, torch.zeros_like(km))
    nq, _, W = km.shape
    out = torch.empty((nq, W, 32), dtype=torch.int32, device=db.device)
    for b in range(32):
        out[:, :, b] = ((km >> b) & 1).sum(dim=1, dtype=torch.int32)
    return out.reshape(nq, W * 32)


def total_hits_ref(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                   threshold_count: torch.Tensor) -> torch.Tensor:
    """Plain total hits: int32 [nq], the number of bit columns of ``db``
    whose hit count (``counts_ref``) is >= threshold_count[q]."""
    counts = counts_ref(db, idx, valid)
    return (counts >= threshold_count[:, None]).sum(dim=1, dtype=torch.int32)


# --- kernel wrappers ----------------------------------------------------------

def _launch_search(name: str, db, idx, valid, out: torch.Tensor,
                   threshold_count: torch.Tensor | None = None, launch=None) -> torch.Tensor:
    """Check the arguments and launch search kernel ``name`` into ``out``
    (int32, nq rows) on the current stream of db's device, through
    ``launch`` (default ``kernels.launch``). What the checks need from the
    device (idx's range, the least threshold) comes back in one host read."""
    nq, nk, nh = idx.shape
    R, W = db.shape
    if db.dtype != torch.int32 or idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("expected db int32, idx int32, valid bool")
    if valid.shape != (nq, nk):
        raise ValueError(f"valid shape {tuple(valid.shape)} != {(nq, nk)}")
    if not (db.device == idx.device == valid.device):
        raise ValueError("db, idx and valid must share a device")
    if db.device.type != "cuda":
        raise ValueError(f"unsupported device {db.device}")
    probes = list(torch.aminmax(idx)) if idx.numel() else []
    if threshold_count is not None and threshold_count.numel():
        probes.append(threshold_count.min())
    values = torch.stack(probes).tolist() if probes else []
    if threshold_count is not None and threshold_count.numel() and values[-1] < 1:
        raise ValueError("threshold_count must be >= 1")
    if nq == 0 or W == 0:
        return out
    if nh == 0:
        raise ValueError("num_hash must be >= 1")
    if idx.numel() and (values[0] < 0 or values[1] >= R):
        raise IndexError(f"slice index out of range [0, {R}): {values[0]}..{values[1]}")
    db, idx, valid = db.contiguous(), idx.contiguous(), valid.contiguous()
    ptrs = [db.data_ptr(), idx.data_ptr(), valid.data_ptr()]
    with torch.cuda.device(db.device):
        if threshold_count is None:
            ptrs.append(out.data_ptr())
        else:
            # search_total_hits' counts [nq, W*32]; back in the
            # stream-ordered cache once the launch is queued.
            scratch = torch.empty(kernels.scratch_words("search", nq, W), dtype=torch.int32,
                                  device=db.device)
            ptrs += [threshold_count.contiguous().data_ptr(), out.data_ptr(),
                     scratch.data_ptr()]
        (launch or kernels.launch)(name, *ptrs, nq, nk, nh, W,
                                   torch.cuda.current_stream(db.device).cuda_stream)
    return out


def _empty_out(db: torch.Tensor, idx: torch.Tensor, cols: int) -> torch.Tensor:
    return torch.empty((idx.shape[0], cols), dtype=torch.int32, device=db.device)


def search_complete(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Threshold == 1.0: packed complete-match mask int32 [nq, W].
    CUDA tensors: the search_complete kernel (num_hash <= 128); CPU
    tensors: complete_ref."""
    if db.device.type == "cpu":
        return complete_ref(db, idx, valid)
    return _launch_search("search_complete", db, idx, valid, _empty_out(db, idx, db.shape[1]))


def search_counts(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Threshold < 1: per-filter hit counts int32 [nq, W*32].
    CUDA tensors: the search_counts kernel (num_hash <= 128); CPU tensors:
    counts_ref."""
    if db.device.type == "cpu":
        return counts_ref(db, idx, valid)
    return _launch_search("search_counts", db, idx, valid,
                          _empty_out(db, idx, db.shape[1] * 32))


def search_total_hits(db: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                      threshold_count: torch.Tensor) -> torch.Tensor:
    """Per-query number of bit columns of ``db`` (all W*32 of them) whose
    hit count is >= threshold_count[q]: int32 [nq]. ``threshold_count`` is
    int32 [nq], every entry >= 1, so all-zero padding columns never count.
    CUDA tensors: the search_total_hits kernel (num_hash <= 128; the counts
    stay in its scratch, never returned); CPU tensors: total_hits_ref."""
    if threshold_count.dtype != torch.int32 or threshold_count.shape != (idx.shape[0],):
        raise ValueError(f"expected threshold_count int32 [{idx.shape[0]}]")
    if threshold_count.device != db.device:
        raise ValueError("threshold_count must lie on db's device")
    if db.device.type == "cpu":
        if threshold_count.numel() and int(threshold_count.min()) < 1:
            raise ValueError("threshold_count must be >= 1")
        return total_hits_ref(db, idx, valid, threshold_count)
    out = torch.zeros(idx.shape[0], dtype=torch.int32, device=db.device)
    return _launch_search("search_total_hits", db, idx, valid, out, threshold_count)


# --- chunked / multi-file search ----------------------------------------------

# A query batch whose distinct slice rows, times the column slabs they
# stream in themselves, are at most this share of the filter length times
# the slabs the whole chunk would stream in, uploads only those rows
# ("gather"); above it the chunk goes to the device whole or in column
# slabs ("full"), and each slab reads every row of the files again. On an
# H100's host (bench.search_routes, PERF.md): 8 fused 1 GiB files at
# L=22, one slab: the gather of 30% of the rows costs about what the whole
# upload does; one 16 GiB file at L=26, three slabs: the gather of 50%
# still takes about half of the full route.
GATHER_SHARE = 0.25
# Threads that fill a staging block: a file piece each, split by rows so
# that a block is READER_THREADS jobs however many files it spans.
READER_THREADS = 8


def _reduce(db: torch.Tensor, idx_d, valid_d, threshold: float) -> torch.Tensor:
    """Complete mask (threshold 1.0) or hit counts of ``db``, on its device."""
    if threshold == 1.0:
        return search_complete(db, idx_d, valid_d)
    return search_counts(db, idx_d, valid_d)


def _to_host(out: torch.Tensor, threshold: float) -> np.ndarray:
    return tensor_to_words(out) if threshold == 1.0 else out.cpu().numpy()


def _add(prof: dict, key: str, value) -> None:
    prof[key] = prof.get(key, 0) + value


def _slab_words(L: int, W: int, budget_bytes: int, result_word_bytes: int) -> int:
    """Words a slab for a host chunk of [L, W] words. One within
    ``budget_bytes`` goes up whole, in one slab (the budget counts a
    chunk's rows, as ``group_file_chunks`` does). A wider one streams
    through one device buffer that shares the budget with the device
    output and one slab's result (``result_word_bytes`` a word each; the
    query batch is not counted), of one word column at the least (a budget
    below that is passed by what lies beside it)."""
    col = 4 * L
    if col * W <= budget_bytes:
        return W
    return max((budget_bytes - result_word_bytes * W) // (col + result_word_bytes), 1)


def eval_chunk_cols(
    words,
    idx_d: torch.Tensor,
    valid_d: torch.Tensor,
    threshold: float,
    budget_bytes: int,
    profile: dict | None = None,
) -> np.ndarray:
    """Hit counts (threshold < 1, int32 [nq, 32*W]) or packed complete
    mask (threshold == 1.0, uint32 [nq, W]) for one fused chunk.

    ``words`` is a device-resident int32 tensor (searched in one kernel
    call), a ``HostChunk`` or a host uint32 [L, W] matrix. A host chunk
    within ``budget_bytes`` uploads as one slab; a wider one streams in
    column slabs through one device buffer allocated once, as wide as the
    budget allows beside the device output (``_slab_words``). A slab's
    copies and its reduction queue on the current stream, so the host
    stages the next slab while the card reduces this one; each slab's
    result goes into its columns of one device output, read back once at
    the end. ``profile`` accumulates ``upload_s`` (a host chunk's staging
    and copies, to their end) and, for a chunk that streams, ``slabs``;
    for a chunk of gathered rows (``HostChunk.rows``) the time the host
    waited on the gather counts under ``gather_s`` instead.
    """
    if isinstance(words, torch.Tensor):
        return _to_host(_reduce(words, idx_d, valid_d, threshold), threshold)
    chunk = words if isinstance(words, HostChunk) else HostChunk([words])
    device = idx_d.device
    L, Wc = chunk.shape
    nq = idx_d.shape[0]
    per_word = 1 if threshold == 1.0 else 32
    slab_w = _slab_words(L, Wc, budget_bytes, 4 * nq * per_word)
    slabs = range(0, Wc, slab_w)
    out = (torch.empty((nq, per_word * Wc), dtype=torch.int32, device=device)
           if len(slabs) > 1 else None)
    buf = torch.empty(L * slab_w, dtype=torch.int32, device=device)
    t_up = 0.0
    with PinnedStager(device) as stager:
        for w0 in slabs:
            w1 = min(w0 + slab_w, Wc)
            db = buf[: L * (w1 - w0)].view(L, w1 - w0)
            t0 = time.perf_counter()
            chunk.columns(w0, w1, device, out=db, stager=stager)
            t_up += time.perf_counter() - t0
            res = _reduce(db, idx_d, valid_d, threshold)
            if out is None:
                out = res
            else:
                out[:, per_word * w0 : per_word * w1] = res
        t0 = time.perf_counter()
        stager.finish()
        t_up += time.perf_counter() - t0
    if profile is not None:
        gathered = stager.wait_s if chunk.rows is not None else 0.0
        _add(profile, "gather_s", gathered)
        _add(profile, "upload_s", t_up - gathered)
        if len(slabs) > 1:
            _add(profile, "slabs", len(slabs))
    return _to_host(out, threshold)


STAGE_BYTES = 64 << 20
# Device bytes kept free for streaming when a corpus passes its budget. What
# streams is uploaded again on every call, in row pieces as wide as the slab
# (or wave), and the host stages narrow pieces slowly (on an H100's host, at
# L=22: 0.9 GiB/s in 32-byte pieces, 3.4 GiB/s in 128-byte ones), so the
# share is wide rather than small: an eighth of the default budget.
SLAB_RESERVE_BYTES = 1 << 30


def resident_cap_bytes(total_bytes: int, budget_bytes: int) -> int:
    """Bytes of ``budget_bytes`` that resident chunks may take: all of it
    when the corpus (``total_bytes``) fits; otherwise what is left beside
    the share kept for streaming (SLAB_RESERVE_BYTES, at most half the
    budget: two wave buffers a shard on a mesh). Chunks are cut at this
    size so that they can go resident."""
    if total_bytes <= budget_bytes:
        return budget_bytes
    return budget_bytes - min(budget_bytes // 2, SLAB_RESERVE_BYTES)


class PinnedStager:
    """Host -> device copies of row blocks through two staging buffers of
    ``nbytes`` each (page-locked on the card), used in turn. Reader threads
    fill the next block while the current one copies; a buffer is refilled
    only after the event of its previous copy. On the CPU the same blocks
    go through plain buffers and synchronous copies. ``wait_s`` sums the
    time the caller waited on the readers. ``finish`` waits for the last
    copies; leaving a ``with`` block also stops the readers."""

    def __init__(self, device: torch.device, nbytes: int = STAGE_BYTES):
        self.device = device
        self.nbytes = nbytes
        self.cuda = device.type == "cuda"
        self.bufs: list[torch.Tensor] = []
        self.events: list = [None, None]
        self.turn = 0
        self.wait_s = 0.0
        self.pool = ThreadPoolExecutor(READER_THREADS)

    def __enter__(self) -> "PinnedStager":
        return self

    def __exit__(self, *exc) -> None:
        self.pool.shutdown()
        self.finish()

    def _stage(self, r0: int, r1: int, row_bytes: int, fill):
        """Start filling rows [r0, r1) into the next buffer once its last
        copy is done: (the buffer's rows as int32, the fill's futures)."""
        i = self.turn
        self.turn ^= 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        stage = self.bufs[i][: (r1 - r0) * row_bytes].view(r1 - r0, row_bytes)
        futures = [self.pool.submit(job) for job in fill(stage.numpy(), r0, r1)]
        return stage.view(torch.int32), futures, i

    def copy(self, dst: torch.Tensor, fill) -> None:
        """Rows of the int32 [R, C] ``dst``, a block of rows a copy, from
        ``fill(host, r0, r1)``: the jobs that write rows [r0, r1) of the
        source, uint8 [r1 - r0, 4 * C], into ``host``."""
        R, C = dst.shape
        if R == 0 or C == 0:
            return
        row_bytes = 4 * C
        size = max(min(self.nbytes, R * row_bytes), row_bytes)
        if not self.bufs or self.bufs[0].numel() < size:
            self.finish()
            self.bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=self.cuda)
                         for _ in range(2)]
        step = self.bufs[0].numel() // row_bytes
        blocks = [(r0, min(r0 + step, R)) for r0 in range(0, R, step)]
        pending = self._stage(*blocks[0], row_bytes, fill)
        for k, (r0, r1) in enumerate(blocks):
            stage, futures, i = pending
            t0 = time.perf_counter()
            for f in futures:
                f.result()
            self.wait_s += time.perf_counter() - t0
            if k + 1 < len(blocks):
                pending = self._stage(*blocks[k + 1], row_bytes, fill)
            dst[r0:r1].copy_(stage, non_blocking=self.cuda)
            if self.cuda:
                self.events[i] = torch.cuda.Event()
                self.events[i].record(torch.cuda.current_stream(self.device))

    def finish(self) -> None:
        for ev in self.events:
            if ev is not None:
                ev.synchronize()


def _slices(reader) -> np.ndarray:
    """A file's slice matrix uint8 [L, slice_size]: memory-mapped where the
    format allows (.db), read otherwise (.dbz)."""
    mm = getattr(reader, "mmap_slices", None)
    return mm() if mm is not None else reader.read_slices()


def _copy_rows(src: np.ndarray, dst: np.ndarray, sel) -> None:
    """Rows ``sel`` (a slice or sorted row indices) of ``src`` into the
    first columns of ``dst``; the rest of each row (a file's pad) zeroed."""
    n = src.shape[1]
    dst[:, :n] = src[sel]
    dst[:, n:] = 0


class HostChunk:
    """A fused chunk held on the host as its files' slice matrices uint8
    [L, slice_size_f], side by side and never joined; with ``rows`` (sorted
    slice rows: a query batch's), only those rows of them, in that order.
    ``columns`` uploads a word range of it through pinned staging, a block
    of rows of every file a copy."""

    def __init__(self, pieces: list[np.ndarray], rows: np.ndarray | None = None):
        self.pieces = [p if p.dtype == np.uint8 else np.ascontiguousarray(p).view(np.uint8)
                       for p in pieces]
        self.rows = rows
        self.widths = [-(-p.shape[1] // 4) for p in self.pieces]
        n_rows = self.pieces[0].shape[0] if rows is None else len(rows)
        self.shape = (n_rows, sum(self.widths))
        self.nbytes = self.shape[0] * self.shape[1] * 4

    def fill(self, host: np.ndarray, r0: int, r1: int, lo: int, hi: int) -> list:
        """The jobs that write rows [r0, r1) x words [lo, hi) into ``host``
        (uint8 [r1 - r0, 4 * (hi - lo)]): a file piece each, split by rows
        into READER_THREADS jobs in all."""
        spans, w0 = [], 0
        for piece, w in zip(self.pieces, self.widths):
            a, b = max(lo, w0), min(hi, w0 + w)
            if a < b:
                spans.append((piece[:, 4 * (a - w0) : 4 * (b - w0)],
                              host[:, 4 * (a - lo) : 4 * (b - lo)]))
            w0 += w
        n = r1 - r0
        parts = min(max(READER_THREADS // max(len(spans), 1), 1), n)
        jobs = []
        for src, dst in spans:
            for p in range(parts):
                q0, q1 = n * p // parts, n * (p + 1) // parts
                sel = (slice(r0 + q0, r0 + q1) if self.rows is None
                       else self.rows[r0 + q0 : r0 + q1])
                jobs.append(functools.partial(_copy_rows, src, dst[q0:q1], sel))
        return jobs

    def columns(self, lo: int, hi: int, device: torch.device,
                out: torch.Tensor | None = None,
                stager: PinnedStager | None = None) -> torch.Tensor:
        """Words [lo, hi) of every row as an int32 tensor [rows, hi - lo] on
        ``device``; ``out`` (int32 [rows, >= hi - lo]) receives them in its
        first columns instead and has the rest zeroed. With ``stager`` the
        copies are queued on the current stream and the call returns without
        waiting for them (the stager's ``finish`` does)."""
        n = hi - lo
        if out is None:
            out = torch.empty((self.shape[0], n), dtype=torch.int32, device=device)
        elif out.shape[1] > max(n, 0):
            out[:, max(n, 0):] = 0
        dst = out if out.shape[1] == n else out[:, : max(n, 0)]
        fill = functools.partial(self.fill, lo=lo, hi=hi)
        if stager is not None:
            stager.copy(dst, fill)
        else:
            with PinnedStager(device) as own:
                own.copy(dst, fill)
        return out


def distinct_rows(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the sorted distinct slice rows of ``idx``, padding entries
    included; ``idx`` as int32 positions in them): what the gather route
    uploads, and the indices that search it."""
    uniq, inv = np.unique(idx, return_inverse=True)
    return uniq, inv.reshape(idx.shape).astype(np.int32)


class QueryBatch:
    """One BloomParam's query batch (``make_query_batch``) for ``device``:
    host ``idx`` / ``nk``, ``valid_d`` and ``idx_d`` on the device, and
    ``rows()``, the distinct slice rows it touches. The mesh's batch
    (``parallel.sharded_search``) places ``idx_d`` through its own
    ``_place``."""

    _idx_d = None
    _rows = None

    def __init__(self, queries: list[str], param, device: torch.device):
        self.idx, valid, self.nk = make_query_batch(
            queries, param.kmer_len, param.num_hash, param.log_2_filter_len)
        self.device = device
        self.valid_d = self._place(valid)

    def _place(self, a: np.ndarray):
        """Host array ``a`` where the kernels read it."""
        return torch.from_numpy(a).to(self.device)

    @property
    def idx_d(self):
        if self._idx_d is None:
            self._idx_d = self._place(self.idx)
        return self._idx_d

    def rows(self) -> tuple[np.ndarray, np.ndarray]:
        """``distinct_rows(idx)``, computed once."""
        if self._rows is None:
            self._rows = distinct_rows(self.idx)
        return self._rows

    def gathers(self, filter_len: int, passes: int = 1, gathered_passes: int = 1) -> bool:
        """Whether a chunk of this filter length, which the full route would
        read in ``passes`` column slabs and the gather route in
        ``gathered_passes``, takes the gather route: the rows read, passes
        counted, at most GATHER_SHARE of what the full route reads. The
        gathered rows count once for each of their own slabs, since each
        slab gathers them from the files again."""
        return len(self.rows()[0]) * gathered_passes <= GATHER_SHARE * filter_len * passes


def search_chunk(words, batch: QueryBatch, threshold: float, budget_bytes: int,
                 profile: dict | None = None) -> np.ndarray:
    """One chunk's result (``eval_chunk_cols``' contract) for ``batch``. A
    device tensor is searched as it is. A ``HostChunk`` takes the gather
    route when the batch's rows, times the column slabs they themselves
    take under ``budget_bytes``, are at most GATHER_SHARE of the chunk's
    rows times the slabs the full route would read it in
    (``QueryBatch.gathers``): only those rows go to the device, gathered
    by the stager's reader threads, searched with ``idx`` remapped to
    them. Otherwise it goes whole, in one slab or several (the "full"
    route). ``profile`` also counts ``route``
    ({"gather": chunks, "full": chunks}), ``rows`` (the distinct slice rows
    of each chunk's batch, summed) and ``gather_bytes`` (the gathered
    rows' bytes)."""
    gather = False
    if isinstance(words, HostChunk):
        L, W = words.shape
        result_word_bytes = 4 * len(batch.nk) * (1 if threshold == 1.0 else 32)
        passes = -(-W // _slab_words(L, W, budget_bytes, result_word_bytes))
        U = len(batch.rows()[0])
        gathered_passes = -(-W // _slab_words(U, W, budget_bytes, result_word_bytes))
        gather = batch.gathers(L, passes, gathered_passes)
    if profile is not None:
        routes = profile.setdefault("route", {"gather": 0, "full": 0})
        routes["gather" if gather else "full"] += 1
        _add(profile, "rows", len(batch.rows()[0]))
    if not gather:
        return eval_chunk_cols(words, batch.idx_d, batch.valid_d, threshold, budget_bytes,
                               profile)
    rows, local = batch.rows()
    gathered = HostChunk(words.pieces, rows)
    if profile is not None:
        _add(profile, "gather_bytes", gathered.nbytes)
    local_d = torch.from_numpy(local).to(batch.device)
    return eval_chunk_cols(gathered, local_d, batch.valid_d, threshold, budget_bytes, profile)


def group_file_chunks(readers, budget: int) -> list[tuple[object, list[int]]]:
    """(BloomParam, [file index, ...]) fused chunks, in first-appearance
    order of the params and file order within each: same-param files fuse
    side by side until the next one would pass ``budget`` bytes (a single
    file wider than the budget is its own chunk)."""
    groups: dict = {}
    for fi, r in enumerate(readers):
        groups.setdefault(r.header.param, []).append(fi)
    chunked: list[tuple[object, list[int]]] = []
    for param, file_idxs in groups.items():
        chunk: list[int] = []
        used = 0
        for fi in file_idxs:
            h = readers[fi].header
            sz = h.filter_len * ((h.slice_size + 3) // 4) * 4
            if chunk and used + sz > budget:
                chunked.append((param, chunk))
                chunk, used = [], 0
            chunk.append(fi)
            used += sz
        if chunk:
            chunked.append((param, chunk))
    return chunked


def read_chunk(readers, file_idxs: list[int]) -> tuple[HostChunk, list[tuple[int, int, int]]]:
    """A chunk's files on the host (``HostChunk``) and their (file index,
    word lo, word hi) spans."""
    pieces = [_slices(readers[fi]) for fi in file_idxs]
    chunk = HostChunk(pieces)
    spans, w0 = [], 0
    for fi, w in zip(file_idxs, chunk.widths):
        spans.append((fi, w0, w0 + w))
        w0 += w
    return chunk, spans


def chunk_words(readers, file_idxs: list[int]) -> int:
    """Words per row of the files side by side."""
    return sum(-(-readers[fi].header.slice_size // 4) for fi in file_idxs)


def fuse_files(readers, file_idxs: list[int], device: torch.device,
               profile: dict | None = None) -> tuple[torch.Tensor, list[tuple[int, int, int]]]:
    """The files side by side in one int32 tensor [L, sum W] on ``device``
    and their (file index, word lo, word hi) spans. Each file is read and
    copied into its column range through pinned staging, then dropped:
    host memory holds one file at a time, never the joined chunk.
    ``profile`` accumulates ``read_s`` (opening or reading the slices) and
    ``upload_s`` (staging and copies, to their end)."""
    L = readers[file_idxs[0]].header.filter_len
    out = torch.empty((L, chunk_words(readers, file_idxs)), dtype=torch.int32, device=device)
    spans, w0 = [], 0
    with PinnedStager(device) as stager:
        for fi in file_idxs:
            t0 = time.perf_counter()
            piece = HostChunk([_slices(readers[fi])])
            t1 = time.perf_counter()
            w = piece.shape[1]
            stager.copy(out[:, w0 : w0 + w], functools.partial(piece.fill, lo=0, hi=w))
            del piece
            if profile is not None:
                _add(profile, "read_s", t1 - t0)
                _add(profile, "upload_s", time.perf_counter() - t1)
            spans.append((fi, w0, w0 + w))
            w0 += w
        t0 = time.perf_counter()
        stager.finish()
        if profile is not None:
            _add(profile, "upload_s", time.perf_counter() - t0)
    return out, spans


def chunk_hits(out: np.ndarray, nk: np.ndarray, spans, readers, threshold: float,
               buckets: dict[int, dict[int, list]], qids: list[int]) -> None:
    """Add one chunk's hits to ``buckets`` (qid -> file index -> [(filter,
    num_found, num_kmers)]): complete mask or counts -> per-file hits."""
    from ..search.engine import query_threshold_count

    for qi, qid in enumerate(qids):
        if nk[qi] == 0:
            continue
        for fi, lo, hi in spans:
            nf = readers[fi].header.num_filter
            if threshold == 1.0:
                hits_mask = unpack_mask(out[qi : qi + 1, lo:hi], nf)[0]
                hits = [(int(f), int(nk[qi])) for f in np.nonzero(hits_mask)[0]]
            else:
                c = out[qi, 32 * lo : 32 * hi][:nf]
                qt = query_threshold_count(threshold, int(nk[qi]))
                hits = [(int(f), int(c[f])) for f in np.nonzero(c >= qt)[0]]
            if hits:
                buckets.setdefault(qid, {}).setdefault(fi, []).extend(
                    (f, nm, int(nk[qi])) for f, nm in hits)


def collect_results(buckets, readers, info_cache: dict) -> dict[int, list]:
    """{qid: [MatchResult]} in file order, then filter index, then a stable
    descending sort on num_kmers_found (the reference's output order)."""
    from ..search.engine import MatchResult

    results: dict[int, list] = {}
    for qid, per_file in buckets.items():
        out = []
        for fi in sorted(per_file):
            for f, nm, n in per_file[fi]:
                info = info_cache.get((fi, f))
                if info is None:
                    info = readers[fi].read_filter_info(f)
                    info_cache[(fi, f)] = info
                out.append(MatchResult(nm, n, info))
        out.sort(key=lambda m: -m.num_kmers_found)
        results[qid] = out
    return results


def search_files_device(
    db_paths: list[str],
    queries: list[tuple[int, str]],
    threshold: float,
    device: torch.device,
    profile: dict | None = None,
):
    """Device search over many database files -> {query_id: [MatchResult]}.

    Files with the same BloomParam fuse side by side (per-file column
    ranges stay word-aligned), in chunks of at most
    KWAGE_FUSION_BUDGET_BYTES (default 8 GiB) of whole files. A chunk
    whose query batch touches at most GATHER_SHARE of its rows uploads
    only those rows, gathered from the memory-mapped files (``search_chunk``);
    otherwise a chunk within the budget uploads whole (``fuse_files``) and
    a single file wider than the budget streams in column slabs. Hit lists
    are identical to the host engine / reference binary. ``profile``
    accumulates ``read_s``, ``gather_s``, ``upload_s``, ``search_s``
    (query prep, kernels and readback), ``hits_s`` (hit lists), ``slabs``
    (a chunk streamed: its slabs), ``route``, ``rows`` and
    ``gather_bytes`` (``search_chunk``).
    """
    from ..io.dbz_file import open_database

    if not queries:
        return {}
    prof = profile if profile is not None else {}
    readers = [open_database(p) for p in db_paths]
    check_device_filter_len(readers)
    budget = fusion_budget_bytes()
    qids = [qid for qid, _ in queries]
    buckets: dict[int, dict[int, list]] = {}
    batches: dict = {}  # param -> QueryBatch; shared across chunks
    for param, file_idxs in group_file_chunks(readers, budget):
        t0 = time.perf_counter()
        if param not in batches:
            batches[param] = QueryBatch([q for _, q in queries], param, device)
        batch = batches[param]
        L = readers[file_idxs[0]].header.filter_len
        # A chunk that fits and goes whole is staged file by file, each
        # file's rows whole into its own staging block and scattered into
        # its columns on the device: about 1.5x faster than staging the
        # fused layout, where each reader writes a slice of every row
        # (bench.search_routes on an H100's host; PERF.md).
        whole = (L * chunk_words(readers, file_idxs) * 4 <= budget
                 and not batch.gathers(L))
        _add(prof, "search_s", time.perf_counter() - t0)
        if whole:
            words, spans = fuse_files(readers, file_idxs, device, prof)
        else:
            t0 = time.perf_counter()
            words, spans = read_chunk(readers, file_idxs)
            _add(prof, "read_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        moved = prof.get("upload_s", 0.0) + prof.get("gather_s", 0.0)
        out = search_chunk(words, batch, threshold, budget, prof)
        del words
        t1 = time.perf_counter()
        chunk_hits(out, batch.nk, spans, readers, threshold, buckets, qids)
        # The chunk's gather and uploads count under gather_s / upload_s alone.
        _add(prof, "search_s", t1 - t0 - (prof.get("upload_s", 0.0)
                                          + prof.get("gather_s", 0.0) - moved))
        _add(prof, "hits_s", time.perf_counter() - t1)
    t0 = time.perf_counter()
    results = collect_results(buckets, readers, {})
    _add(prof, "hits_s", time.perf_counter() - t0)
    return results


class DeviceSearcher:
    """One database file resident on ``device``, searchable in query
    batches. Hit lists are identical to the host engine."""

    def __init__(self, header, slices: np.ndarray, device: torch.device):
        self.header = header
        self.device = device
        self.db = words_to_tensor(db_bytes_to_words(slices), device)

    @classmethod
    def from_file(cls, path: str, device: torch.device):
        from ..io.dbz_file import open_database

        reader = open_database(path)
        return cls(reader.header, reader.read_slices(), device), reader

    def search(self, queries: list[str], threshold: float):
        """Per-query [(filter_idx, num_found, num_kmers), ...] lists (None
        for a query with no valid k-mers)."""
        from ..search.engine import query_threshold_count

        if not queries:
            return []
        hdr = self.header
        idx, valid, nk = make_query_batch(
            queries, hdr.kmer_len, hdr.num_hash, hdr.log_2_filter_len)
        idx_d = torch.from_numpy(idx).to(self.device)
        valid_d = torch.from_numpy(valid).to(self.device)
        out = []
        if threshold == 1.0:
            mask = unpack_mask(tensor_to_words(search_complete(self.db, idx_d, valid_d)),
                               hdr.num_filter)
            for qi in range(len(queries)):
                if nk[qi] == 0:
                    out.append(None)
                    continue
                hits = np.nonzero(mask[qi])[0]
                out.append([(int(f), int(nk[qi]), int(nk[qi])) for f in hits])
        else:
            counts = search_counts(self.db, idx_d, valid_d).cpu().numpy()[:, : hdr.num_filter]
            for qi in range(len(queries)):
                if nk[qi] == 0:
                    out.append(None)
                    continue
                qt = query_threshold_count(threshold, int(nk[qi]))
                hits = np.nonzero(counts[qi] >= qt)[0]
                out.append([(int(f), int(counts[qi, f]), int(nk[qi])) for f in hits])
        return out
