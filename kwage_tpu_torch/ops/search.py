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
"""

from __future__ import annotations

import os
import time

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

def _reduce(db: torch.Tensor, idx_d, valid_d, threshold: float) -> np.ndarray:
    if threshold == 1.0:
        return tensor_to_words(search_complete(db, idx_d, valid_d))
    return search_counts(db, idx_d, valid_d).cpu().numpy()


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
    wider than ``budget_bytes`` streams through the device in column slabs
    of ``budget_bytes // (L * 4)`` words, each uploaded (through pinned
    staging) as its own contiguous buffer and released before the next
    upload (peak device memory: one slab). ``profile`` accumulates
    ``slabs`` and ``upload_s`` (a host chunk's uploads, to their end).
    """
    if isinstance(words, torch.Tensor):
        return _reduce(words, idx_d, valid_d, threshold)
    chunk = words if isinstance(words, HostChunk) else HostChunk([words])
    device = idx_d.device
    L, Wc = chunk.shape
    slab_w = max(int(budget_bytes // (L * 4)), 1)
    prof = profile if profile is not None else {}
    parts = []
    for w0 in range(0, Wc, slab_w):
        t0 = time.perf_counter()
        db = chunk.columns(w0, min(w0 + slab_w, Wc), device)
        prof["upload_s"] = prof.get("upload_s", 0.0) + time.perf_counter() - t0
        prof["slabs"] = prof.get("slabs", 0) + 1
        parts.append(_reduce(db, idx_d, valid_d, threshold))
        del db  # release before the next slab uploads
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)


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
    """Host -> device copies of row blocks through two pinned staging
    buffers of ``nbytes`` each, used in turn; a buffer is refilled only
    after the event of its previous copy. On the CPU the rows are copied
    straight into the destination. ``finish`` waits for the last copies."""

    def __init__(self, device: torch.device, nbytes: int = STAGE_BYTES):
        self.device = device
        self.nbytes = nbytes
        self.bufs: list[torch.Tensor] = []
        self.events: list = [None, None]
        self.turn = 0

    def copy(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """``src`` uint8 [R, n] (n <= 4 * dst's columns; the rest of each
        row is zero) into the int32 [R, C] view ``dst``."""
        R, C = dst.shape
        if self.device.type != "cuda":
            host = dst.numpy().view(np.uint8)
            host[:, : src.shape[1]] = src
            host[:, src.shape[1]:] = 0
            return
        if not self.bufs:
            self.bufs = [torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=True)
                         for _ in range(2)]
        step = max(self.nbytes // (4 * C), 1)
        for r0 in range(0, R, step):
            r1 = min(r0 + step, R)
            i = self.turn
            self.turn ^= 1
            if self.events[i] is not None:
                self.events[i].synchronize()
            stage = self.bufs[i][: (r1 - r0) * 4 * C].view(r1 - r0, 4 * C)
            host = stage.numpy()
            host[:, : src.shape[1]] = src[r0:r1]
            host[:, src.shape[1]:] = 0
            dst[r0:r1].copy_(stage.view(torch.int32), non_blocking=True)
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


class HostChunk:
    """A fused chunk held on the host as its files' slice matrices uint8
    [L, slice_size_f], side by side and never joined: ``columns`` uploads a
    word range of it through pinned staging, each file's part into its
    columns of one device tensor."""

    def __init__(self, pieces: list[np.ndarray]):
        self.pieces = [p if p.dtype == np.uint8 else np.ascontiguousarray(p).view(np.uint8)
                       for p in pieces]
        self.widths = [-(-p.shape[1] // 4) for p in self.pieces]
        self.shape = (self.pieces[0].shape[0], sum(self.widths))
        self.nbytes = self.shape[0] * self.shape[1] * 4

    def columns(self, lo: int, hi: int, device: torch.device,
                out: torch.Tensor | None = None) -> torch.Tensor:
        """Words [lo, hi) of every row as an int32 tensor [L, hi - lo] on
        ``device``; ``out`` (int32 [L, >= hi - lo]) receives them in its
        first columns instead and has the rest zeroed."""
        if out is None:
            out = torch.empty((self.shape[0], hi - lo), dtype=torch.int32, device=device)
        else:
            out[:, max(hi - lo, 0):] = 0
        stager = PinnedStager(device)
        w0 = 0
        for piece, w in zip(self.pieces, self.widths):
            a, b = max(lo, w0), min(hi, w0 + w)
            if a < b:
                part = piece[:, 4 * (a - w0) : 4 * (b - w0)]
                stager.copy(out[:, a - lo : b - lo], part)
            w0 += w
        stager.finish()
        return out


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
    stager = PinnedStager(device)
    spans, w0 = [], 0
    for fi in file_idxs:
        t0 = time.perf_counter()
        slices = _slices(readers[fi])
        t1 = time.perf_counter()
        w = -(-slices.shape[1] // 4)
        stager.copy(out[:, w0 : w0 + w], slices)
        del slices
        if profile is not None:
            profile["read_s"] = profile.get("read_s", 0.0) + t1 - t0
            profile["upload_s"] = profile.get("upload_s", 0.0) + time.perf_counter() - t1
        spans.append((fi, w0, w0 + w))
        w0 += w
    t0 = time.perf_counter()
    stager.finish()
    if profile is not None:
        profile["upload_s"] = profile.get("upload_s", 0.0) + time.perf_counter() - t0
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

    Files with the same BloomParam fuse side by side into one wide matrix
    on the device (per-file column ranges stay word-aligned; each file
    uploads into its range, ``fuse_files``), in chunks of at most
    KWAGE_FUSION_BUDGET_BYTES (default 8 GiB); a single file wider than
    the budget streams in column slabs. Hit lists are identical to the
    host engine / reference binary. ``profile`` accumulates ``read_s``,
    ``upload_s``, ``search_s`` (query prep, kernels and readback),
    ``hits_s`` (hit lists) and ``slabs`` (a chunk streamed: its slabs).
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
    batch_cache: dict = {}  # param -> (idx_d, valid_d, nk); shared across chunks
    for param, file_idxs in group_file_chunks(readers, budget):
        L = readers[file_idxs[0]].header.filter_len
        if L * chunk_words(readers, file_idxs) * 4 <= budget:
            fused, spans = fuse_files(readers, file_idxs, device, prof)
        else:
            t0 = time.perf_counter()
            fused, spans = read_chunk(readers, file_idxs)
            prof["read_s"] = prof.get("read_s", 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        if param not in batch_cache:
            idx, valid, nk = make_query_batch(
                [q for _, q in queries], param.kmer_len, param.num_hash,
                param.log_2_filter_len)
            batch_cache[param] = (torch.from_numpy(idx).to(device),
                                  torch.from_numpy(valid).to(device), nk)
        idx_d, valid_d, nk = batch_cache[param]
        uploaded = prof.get("upload_s", 0.0)
        out = eval_chunk_cols(fused, idx_d, valid_d, threshold, budget, prof)
        del fused
        t1 = time.perf_counter()
        chunk_hits(out, nk, spans, readers, threshold, buckets, qids)
        # A host chunk's slab uploads count under upload_s alone.
        prof["search_s"] = (prof.get("search_s", 0.0) + t1 - t0
                            - (prof.get("upload_s", 0.0) - uploaded))
        prof["hits_s"] = prof.get("hits_s", 0.0) + time.perf_counter() - t1
    t0 = time.perf_counter()
    results = collect_results(buckets, readers, {})
    prof["hits_s"] = prof.get("hits_s", 0.0) + time.perf_counter() - t0
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
