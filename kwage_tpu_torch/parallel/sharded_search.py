"""Column-sharded bit-slice search over a device mesh (PyTorch + CUDA port
of kwage_tpu/parallel/sharded_search.py).

The signature matrix [filter_len, W] is split along the packed-filter axis
("filters"); the query batch is split by rows along "data", and every slot
(d, f) of the mesh searches query rows d against column shard f with the
single-device kernels (``ops.search``: search_complete, search_counts,
search_total_hits), on its own device and its own stream. The shard outputs
concatenate with no collective -- the counterpart of concatenating
per-database-file hit lists in the reference (kwage.cpp:154-177); only the
corpus totals are summed over the shards. Slots that share a device and a
column shard (logical shards, ``parallel.mesh``) share one tensor.

A mesh output is a ``ShardedArray`` (the shards where they were computed);
``to_host`` assembles the global numpy array, on every process when the
mesh spans processes.

A group that is not resident is searched by the gather route of
``ops.search`` where a query batch touches few of its rows: only those
rows go to the shards, each shard its column range of them.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..ops import search as _search
from ..ops.search import (
    HostChunk,
    PinnedStager,
    QueryBatch,
    _add,
    _slices,
    check_device_filter_len,
    chunk_words,
    collect_results,
    fusion_budget_bytes,
    group_file_chunks,
    make_query_batch,
    resident_cap_bytes,
    search_complete,
    search_counts,
    search_total_hits,
    unpack_mask,
)
from .mesh import SearchMesh


# --- placed inputs and mesh outputs -----------------------------------------------

class MeshMatrix:
    """A signature matrix placed on a mesh: column shard f is an int32
    tensor [L, shard_w] on each device that holds a slot (., f) of this
    process, once per device."""

    def __init__(self, mesh: SearchMesh, shards: dict):
        self.mesh = mesh
        self.shards = shards          # (device, f) -> tensor

    def shard(self, d: int, f: int) -> torch.Tensor:
        return self.shards[(self.mesh.devices[d, f], f)]


def _matrix_keys(mesh: SearchMesh) -> list[tuple[torch.device, int]]:
    """The distinct (device, column shard) pairs this process holds."""
    return list(dict.fromkeys((mesh.devices[d, f], f) for d, f in mesh.local_slots()))


def _upload_matrix(mesh: SearchMesh, chunk: HostChunk, col0: int, ncols: int, shard_w: int,
                   bufs: dict | None = None, stagers: dict | None = None) -> MeshMatrix:
    """Words [col0, col0 + ncols) of ``chunk`` as a MeshMatrix of shards
    ``shard_w`` wide (zero columns past the real ones), each shard staged
    from the chunk's files into ``bufs[(device, f)]`` or a new tensor,
    through ``stagers[device]`` (a ``PinnedStager``, whose copies this
    call waits for) or one of its own a shard."""
    shards = {}
    for dev, f in _matrix_keys(mesh):
        out = (torch.empty((chunk.shape[0], shard_w), dtype=torch.int32, device=dev)
               if bufs is None else bufs[(dev, f)])
        lo = min(col0 + f * shard_w, col0 + ncols)
        hi = min(lo + shard_w, col0 + ncols)
        shards[(dev, f)] = chunk.columns(lo, hi, dev, out=out,
                                         stager=None if stagers is None else stagers[dev])
    for stager in (stagers or {}).values():
        stager.finish()
    return MeshMatrix(mesh, shards)


def place_matrix(mesh: SearchMesh, words) -> MeshMatrix:
    """A host uint32 matrix [L, W] (W a multiple of the filter shards) on
    the mesh; a MeshMatrix passes through."""
    if isinstance(words, MeshMatrix):
        return words
    words = np.ascontiguousarray(words)
    n_shards = mesh.shape["filters"]
    if words.shape[1] % n_shards:
        raise ValueError(f"{words.shape[1]} word columns do not divide into {n_shards} shards")
    return _upload_matrix(mesh, HostChunk([words]), 0, words.shape[1],
                          words.shape[1] // n_shards)


def place_rows(mesh: SearchMesh, arr) -> dict:
    """A per-query host array split by rows over "data": (device, d) ->
    tensor of rows d, on every device that holds a slot (d, .) of this
    process. An already placed dict passes through."""
    if isinstance(arr, dict):
        return arr
    arr = np.ascontiguousarray(arr)
    n_data = mesh.shape["data"]
    if arr.shape[0] % n_data:
        raise ValueError(f"{arr.shape[0]} query rows do not divide into {n_data} data shards")
    rows = arr.shape[0] // n_data
    placed = {}
    for d, f in mesh.local_slots():
        key = (mesh.devices[d, f], d)
        if key not in placed:
            placed[key] = torch.from_numpy(arr[d * rows:(d + 1) * rows].copy()).to(key[0])
    return placed


def _slot_stream(mesh: SearchMesh, d: int, f: int):
    stream = mesh.stream(d, f)
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _sync_devices(mesh: SearchMesh) -> None:
    """Wait for the uploads enqueued on each local CUDA device's current
    stream, so that the slots' own streams may read them."""
    for dev in {mesh.devices[d, f] for d, f in mesh.local_slots()}:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


class ShardedArray:
    """A mesh output: ``parts[(d, f)]`` is slot (d, f)'s int32 result, on
    its device, for this process's slots. ``reduce`` says how the shards
    make the global array: "concat" (rows over "data", columns over
    "filters") or "sum" (rows over "data", summed over "filters")."""

    def __init__(self, mesh: SearchMesh, parts: dict, reduce: str):
        self.mesh = mesh
        self.parts = parts
        self.reduce = reduce


def _all_parts(arr: ShardedArray) -> dict:
    """(d, f) -> numpy part for EVERY slot of the mesh: this process's read
    back from their devices, the others' all-gathered."""
    mesh = arr.mesh
    local = {}
    for (d, f), t in arr.parts.items():
        with _slot_stream(mesh, d, f):
            local[(d, f)] = t.cpu()
    if not mesh.spans_processes:
        return {slot: t.numpy() for slot, t in local.items()}
    import torch.distributed as dist

    world = dist.get_world_size()
    by_rank = [[(d, f) for d in range(mesh.shape["data"]) for f in range(mesh.shape["filters"])
                if int(mesh.owners[d, f]) == r] for r in range(world)]
    if len({len(slots) for slots in by_rank}) != 1:
        raise ValueError("the processes of a mesh must hold equally many slots")
    mine = torch.stack([local[slot] for slot in by_rank[mesh.rank]])
    if dist.get_backend() == "nccl":   # NCCL moves CUDA tensors only
        mine = mine.to(mesh.devices[by_rank[mesh.rank][0]])
    gathered = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(gathered, mine)
    return {slot: gathered[r][i].cpu().numpy()
            for r, slots in enumerate(by_rank) for i, slot in enumerate(slots)}


def to_host(arr) -> np.ndarray:
    """Read a mesh output back as the GLOBAL array on every process.

    A single-process mesh (logical shards included) reads its shards back
    directly. When the mesh spans processes (``parallel.distributed``) the
    shards a process does not hold are all-gathered, so every process sees
    the full result -- the counterpart of the reference's rank-0 MPI result
    merge (SriRachA/main.cpp:462-531), except no process is special."""
    if not isinstance(arr, ShardedArray):
        return np.asarray(arr)
    parts = _all_parts(arr)
    n_data, n_shards = arr.mesh.shape["data"], arr.mesh.shape["filters"]
    rows = []
    for d in range(n_data):
        row = [parts[(d, f)] for f in range(n_shards)]
        rows.append(np.concatenate(row, axis=1) if arr.reduce == "concat"
                    else np.sum(row, axis=0, dtype=np.int32))
    return np.concatenate(rows, axis=0)


def _run_sharded(mesh: SearchMesh, fn, db, *rows) -> dict:
    """fn(column shard f, *query rows d) on every local slot (d, f), each
    on its device and its stream: (d, f) -> result tensor."""
    db = place_matrix(mesh, db)
    rows = [place_rows(mesh, r) for r in rows]
    _sync_devices(mesh)
    parts = {}
    for d, f in mesh.local_slots():
        dev = mesh.devices[d, f]
        with _slot_stream(mesh, d, f):
            parts[(d, f)] = fn(db.shard(d, f), *(r[(dev, d)] for r in rows))
    return parts


def sharded_total_hits(mesh: SearchMesh, db, idx, kmer_valid, threshold_count) -> ShardedArray:
    """int32 [nq]: number of filters meeting the per-query threshold over
    all filter shards. Each slot counts its shard's columns on the device
    (the search_total_hits kernel: the counts never reach device memory);
    ``to_host`` sums the shards (the counterpart of the reference's
    MPI_Allreduce(SUM) reconciliations, SriRachA/main.cpp:535-550)."""
    return ShardedArray(mesh, _run_sharded(mesh, search_total_hits, db, idx, kmer_valid,
                                           threshold_count), "sum")


def sharded_search_counts(mesh: SearchMesh, db, idx, kmer_valid) -> ShardedArray:
    return ShardedArray(mesh, _run_sharded(mesh, search_counts, db, idx, kmer_valid), "concat")


def sharded_search_complete(mesh: SearchMesh, db, idx, kmer_valid) -> ShardedArray:
    return ShardedArray(mesh, _run_sharded(mesh, search_complete, db, idx, kmer_valid), "concat")


# --- one BloomParam group on the mesh ------------------------------------------------

def _wave_plan(L: int, W: int, n_shards: int, budget_bytes: int,
               stream: bool = False) -> tuple[list[tuple[int, int, int]], bool]:
    """The column waves of an [L, W] word matrix under ``budget_bytes`` a
    shard: ([(first word column, word columns, padded width)], whether it
    streams). A matrix within budget * n_shards goes in one wave (unless
    ``stream``); a wider one streams in waves of budget/2 a shard, since
    the next wave uploads beside the current one, every wave of one padded
    width so that two buffers a shard serve them all."""
    bytes_per_word_col = L * 4
    # Columns per wave: the per-shard budget times the shard count,
    # floored to at least one column per shard.
    max_cols = max((budget_bytes * n_shards) // max(bytes_per_word_col, 1), n_shards)
    multi_wave = stream or W > max_cols
    if multi_wave:
        # Halve the per-wave footprint to hold the per-shard budget at peak.
        # Floor to a multiple of n_shards so the uniform shard padding can't
        # push a wave past budget/2.
        max_cols = max((budget_bytes // 2 * n_shards) // max(bytes_per_word_col, 1), n_shards)
        max_cols = max((max_cols // n_shards) * n_shards, n_shards)
    uniform = max_cols + ((-max_cols) % n_shards)
    waves = []
    for col0 in range(0, max(W, 1), max_cols):
        ncols = min(max_cols, W - col0)
        width = uniform if multi_wave else ncols + ((-ncols) % n_shards)
        waves.append((col0, ncols, width))
    return waves, multi_wave


class _MeshBatch(QueryBatch):
    """A query batch padded for the mesh (``ShardedDatabase._prep``):
    ``QueryBatch``'s ``idx``, ``nk``, ``rows()`` and ``gathers``, with
    ``idx_d`` and ``valid`` placed over "data", and the padded row count
    ``nq_b``."""

    def __init__(self, mesh: SearchMesh, idx, valid, nk, nq_b: int):
        self.mesh = mesh
        self.idx = idx
        self.nk = nk
        self.nq_b = nq_b
        self.valid = self._place(valid)

    def _place(self, a: np.ndarray) -> dict:
        return place_rows(self.mesh, a)


@contextlib.contextmanager
def _search_clock(profile: dict | None):
    """Adds the block's wall to ``profile["search_s"]``, less what the
    block added to ``gather_s`` and ``upload_s``."""
    if profile is None:
        yield
        return

    def moved():
        return profile.get("gather_s", 0.0) + profile.get("upload_s", 0.0)

    before, t0 = moved(), time.perf_counter()
    yield
    _add(profile, "search_s", time.perf_counter() - t0 - (moved() - before))


class ShardedDatabase:
    """One BloomParam group of the corpus, sharded across a device mesh.

    Filters from many database files (same shape) lie side by side along
    the packed-word axis, split over the "filters" mesh axis; queries are
    batched over "data".

    Memory discipline: each shard holds at most ``budget_bytes`` of
    signature matrix at a time (default KWAGE_FUSION_BUDGET_BYTES, the
    same knob as the single-device path, ops/search.py), so a card that
    holds several logical shards holds that many budgets. A corpus wider
    than budget * n_shards streams through the mesh in column waves -- the
    sharded counterpart of the reference's 1 GiB transpose-buffer
    discipline (build_db.cpp:236-248). A single-wave corpus stays
    device-resident (unless ``resident`` is False: then it goes up in each
    search call, as one wave). Multi-wave streaming uploads the NEXT wave
    while the current one computes, into the other of two buffers a shard
    (allocated for the call, never a third); waves are therefore sized at
    budget_bytes/2 a shard, keeping the peak within budget. ``stream``
    forces that sizing and keeps nothing resident (``build_sharded_groups``
    asks for it when the budget is shared with resident groups).

    A group that is not resident takes the gather route of
    ``ops.search.search_chunk`` for a query batch whose distinct slice rows,
    times the waves they take themselves, are at most
    ``ops.search.GATHER_SHARE`` of the filter length for each wave the full
    route would take: only those rows go up, each shard its
    column range of them, under the same budget a shard (in column waves
    where they pass it), searched with the batch's indices remapped to
    them. The counts and masks are those of the full route.

    The host keeps the files as they are (``HostChunk``: memory-mapped
    .db, decompressed .dbz) and stages each file's columns into the shards'
    column ranges; it never joins them.
    """

    def __init__(self, mesh: SearchMesh, param, slices: np.ndarray, num_filter: int,
                 budget_bytes: int | None = None):
        self._init_from_chunk(mesh, param, HostChunk([slices]), num_filter, budget_bytes)

    @classmethod
    def from_files(cls, mesh: SearchMesh, db_paths: list[str],
                   budget_bytes: int | None = None, stream: bool = False,
                   resident: bool = True) -> "ShardedDatabase":
        """Fuse same-shape .db/.dbz files (in the given order) into one
        sharded group; file order then filter index is preserved so hit
        lists match the host engine byte-for-byte. Each file's columns
        stay word-aligned via its on-disk byte padding."""
        from ..io.dbz_file import open_database

        readers = [open_database(p) for p in db_paths]
        params = {r.header.param for r in readers}
        if len(params) != 1:
            raise ValueError("from_files requires a single BloomParam group")
        chunk = HostChunk([_slices(r) for r in readers])
        obj = cls.__new__(cls)
        obj._init_from_chunk(mesh, readers[0].header.param, chunk,
                             sum(r.header.num_filter for r in readers), budget_bytes, stream,
                             resident)
        # (word_lo, word_hi, num_filter) per file, in path order.
        spans, w0 = [], 0
        for r, w in zip(readers, chunk.widths):
            spans.append((w0, w0 + w, r.header.num_filter))
            w0 += w
        obj.file_spans = spans
        return obj

    def _init_from_chunk(self, mesh, param, chunk: HostChunk, num_filter, budget_bytes,
                         stream: bool = False, resident: bool = True):
        self.mesh = mesh
        self.param = param
        self.num_filter = num_filter
        if budget_bytes is None:
            budget_bytes = fusion_budget_bytes()
        self._budget_bytes = budget_bytes
        n_shards = mesh.shape["filters"]
        L, W = chunk.shape
        self._waves, multi_wave = _wave_plan(L, W, n_shards, budget_bytes, stream)
        self.num_cols = W * 32
        self.num_waves = len(self._waves)
        self.W = sum(width for _, _, width in self._waves)
        self.filter_len = L
        # Bytes a shard holds of the widest wave.
        self.wave_shard_bytes = max(w for _, _, w in self._waves) // n_shards * L * 4
        # Resident fast path: a single-wave corpus lives on the devices,
        # and the host lets go of the files.
        self._chunk = chunk
        self.db = None
        if not multi_wave and resident:
            self.db = _upload_matrix(mesh, chunk, *self._waves[0][:2],
                                     self._waves[0][2] // n_shards)
            self._chunk = None

    def _stream(self, chunk: HostChunk, waves, launch, collect, profile: dict | None) -> list:
        """``collect(launch(db), real)`` for every wave of ``chunk``, in order.

        ``launch`` enqueues a wave's kernels and returns their outputs;
        ``collect`` reads them back, which blocks until the kernels have
        consumed the wave. A stream holds two buffers a shard: wave i + 1
        is staged into the one that wave i - 1 (collected, so no longer
        read) left, after wave i's kernels are enqueued, so the upload
        overlaps them -- and a third wave is never alive. One stager a
        device serves every shard and wave of the call; ``profile`` adds
        ``upload_s`` (``gather_s``: the time the host waited on the reader
        threads, for gathered rows) and ``waves``.
        """
        keys = _matrix_keys(self.mesh)
        shard_w = waves[0][2] // self.mesh.shape["filters"]
        bufs = [{key: torch.empty((chunk.shape[0], shard_w), dtype=torch.int32, device=key[0])
                 for key in keys} for _ in range(min(len(waves), 2))]
        t_up = 0.0
        with contextlib.ExitStack() as stack:
            stagers = {dev: stack.enter_context(PinnedStager(dev))
                       for dev in dict.fromkeys(dev for dev, _ in keys)}

            def upload(i: int) -> MeshMatrix:
                nonlocal t_up
                col0, ncols, _ = waves[i]
                t0 = time.perf_counter()
                db = _upload_matrix(self.mesh, chunk, col0, ncols, shard_w, bufs[i % 2], stagers)
                t_up += time.perf_counter() - t0
                return db

            out = []
            pending = upload(0)
            for i, (_, ncols, _) in enumerate(waves):
                launched = launch(pending)
                if i + 1 < len(waves):
                    pending = upload(i + 1)
                out.append(collect(launched, ncols * 32))
        if profile is not None:
            gathered = sum(st.wait_s for st in stagers.values()) if chunk.rows is not None else 0.0
            _add(profile, "gather_s", gathered)
            _add(profile, "upload_s", t_up - gathered)
            _add(profile, "waves", len(waves))
        return out

    def _map_waves(self, batch: _MeshBatch, launch, collect, profile: dict | None = None) -> list:
        """``collect(launch(db, idx), real)`` for every wave, in order, for
        ``batch``: the resident matrix as it is; otherwise the gather route
        (``QueryBatch.gathers``: the batch's distinct rows times the waves
        they take at most GATHER_SHARE x filter length x the waves of the
        full route; those rows, in waves of the same budget a shard, with
        ``idx`` remapped to them) or the full route (every row, in this
        group's waves). ``profile`` also counts
        ``route`` ({"gather", "full", "resident"}: groups), ``rows`` (each
        streamed group's distinct rows, summed) and ``gather_bytes``."""
        routes = None if profile is None else profile.setdefault("route",
                                                                 {"gather": 0, "full": 0})
        if self.db is not None:
            if routes is not None:
                routes["resident"] = routes.get("resident", 0) + 1
            return [collect(launch(self.db, batch.idx_d), self._waves[0][1] * 32)]
        rows, local = batch.rows()
        chunk = HostChunk(self._chunk.pieces, rows)
        waves, _ = _wave_plan(len(rows), chunk.shape[1], self.mesh.shape["filters"],
                              self._budget_bytes)
        gather = batch.gathers(self.filter_len, self.num_waves, len(waves))
        if profile is not None:
            routes["gather" if gather else "full"] += 1
            _add(profile, "rows", len(rows))
        if not gather:
            return self._stream(self._chunk, self._waves,
                                lambda db: launch(db, batch.idx_d), collect, profile)
        if profile is not None:
            _add(profile, "gather_bytes", chunk.nbytes)
        idx = place_rows(self.mesh, local)
        return self._stream(chunk, waves, lambda db: launch(db, idx), collect, profile)

    def _prep(self, queries: list[str]) -> _MeshBatch:
        idx, valid, nk = make_query_batch(
            queries,
            self.param.kmer_len,
            self.param.num_hash,
            self.param.log_2_filter_len,
        )
        # Bucket both query-batch axes as the JAX class does (there every
        # distinct shape is a compile; here it keeps the shapes the same),
        # then pad the batch to a multiple of the data axis.
        n_data = self.mesh.shape["data"]
        nq_b = max(n_data, 1 << int(np.ceil(np.log2(max(idx.shape[0], 1)))))
        nq_b += (-nq_b) % n_data
        nk_b = max(128, ((idx.shape[1] + 127) // 128) * 128)
        pad_q = nq_b - idx.shape[0]
        pad_k = nk_b - idx.shape[1]
        if pad_q or pad_k:
            idx = np.pad(idx, ((0, pad_q), (0, pad_k), (0, 0)))
            valid = np.pad(valid, ((0, pad_q), (0, pad_k)))
        return _MeshBatch(self.mesh, idx, valid, nk, nq_b)

    def counts_cols(self, queries: list[str],
                    profile: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Hit counts in packed-column space int [nq, num_cols] + k-mer
        counts (fused-file padding columns included; callers with word
        spans map columns to (file, filter)). ``profile``: the keys of
        ``ops.search.search_files_device`` (``search_s``: query prep,
        kernels and readback) and ``waves``."""
        with _search_clock(profile):
            batch = self._prep(queries)
            parts = self._map_waves(
                batch, lambda db, idx: sharded_search_counts(self.mesh, db, idx, batch.valid),
                lambda out, real: to_host(out)[: len(queries), :real], profile)
        counts = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        return counts, batch.nk

    def complete_cols(self, queries: list[str],
                      profile: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Complete-match bool mask in packed-column space [nq, num_cols]."""
        with _search_clock(profile):
            batch = self._prep(queries)
            parts = self._map_waves(
                batch, lambda db, idx: sharded_search_complete(self.mesh, db, idx, batch.valid),
                lambda out, real: unpack_mask(
                    to_host(out).view(np.uint32)[: len(queries)], real), profile)
        mask = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
        return mask, batch.nk

    def search_counts(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Per-filter hit counts int [nq, num_filter] + per-query k-mer counts."""
        counts, nk = self.counts_cols(queries)
        return counts[:, : self.num_filter], nk

    def total_hits(self, queries: list[str], threshold: float,
                   profile: dict | None = None) -> np.ndarray:
        """Per-query corpus-wide matching-filter totals (summed over the
        "filters" axis). threshold must be > 0 so zero-count padding
        columns never match."""
        from ..search.engine import query_threshold_count

        with _search_clock(profile):
            batch = self._prep(queries)
            qt = np.ones(batch.nq_b, dtype=np.int32)  # padding queries: qt=1
            for i in range(len(queries)):
                qt[i] = max(query_threshold_count(threshold, int(batch.nk[i])), 1)
            qt_d = place_rows(self.mesh, qt)
            parts = self._map_waves(
                batch, lambda db, idx: sharded_total_hits(self.mesh, db, idx, batch.valid, qt_d),
                lambda out, _real: to_host(out).astype(np.int64), profile)
        totals = np.zeros(batch.nq_b, dtype=np.int64)
        for p in parts:
            totals += p
        return totals[: len(queries)]

    def search_complete(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Complete-match bool mask [nq, num_filter] + per-query k-mer counts."""
        mask, nk = self.complete_cols(queries)
        return mask[:, : self.num_filter], nk


# --- many files -----------------------------------------------------------------------

def build_sharded_groups(
    mesh: SearchMesh,
    db_paths: list[str],
    budget_bytes: int | None = None,
):
    """Fuse .db/.dbz files into budget-disciplined ShardedDatabase groups.

    Returns [(ShardedDatabase, file_indices)] in first-appearance order. A
    BloomParam group whose fused matrix exceeds budget * n_shards splits
    into file chunks (the single-device chunk discipline, ops/search.py)
    before the per-chunk column waves bound device memory. Keep the
    returned groups alive to serve many query batches without reloading
    (the mesh serving primitive; see search/resident.py for the
    single-device one).

    The budget is shared ACROSS groups, by one rule: resident chunks plus
    the two transient waves of a streaming chunk stay <= budget_bytes per
    shard (so <= budget_bytes x its shards on a card that holds several
    logical shards). When every chunk fits together, all go resident (the
    serving fast path). Otherwise the waves' share is set aside first
    (``ops.search.resident_cap_bytes``), the files are cut into chunks of
    what is left so that chunks can go resident, in order, while they fit
    it; every other chunk streams -- whether or not it would fit by itself
    -- in two-buffer waves of what the resident ones left. (The JAX
    function hands such a chunk the budget left and lets it go resident
    unaccounted when it fits, which over-commits the device.)
    """
    from ..io.dbz_file import open_database

    readers = [open_database(p) for p in db_paths]
    check_device_filter_len(readers)
    if budget_bytes is None:
        budget_bytes = fusion_budget_bytes()
    n_shards = mesh.shape["filters"]

    def chunk_shard_bytes(chunk):
        # Resident footprint per shard, including the pad-to-n_shards
        # columns a single-wave matrix carries.
        cols = chunk_words(readers, chunk)
        cols += (-cols) % n_shards
        return cols * readers[chunk[0]].header.filter_len * 4 // n_shards

    chunked = [c for _, c in group_file_chunks(readers, budget_bytes * n_shards)]
    resident_cap = resident_cap_bytes(sum(chunk_shard_bytes(c) for c in chunked), budget_bytes)
    if resident_cap < budget_bytes:
        chunked = [c for _, c in group_file_chunks(readers, resident_cap * n_shards)]
    spent = 0
    resident = []
    for sz in map(chunk_shard_bytes, chunked):
        ok = spent + sz <= resident_cap
        resident.append(ok)
        if ok:
            spent += sz
    # Streaming chunks size their waves within what the FINAL resident
    # total leaves free (a running subtraction would let a later resident
    # chunk overlap an earlier streaming chunk's waves).
    return [
        (
            ShardedDatabase.from_files(
                mesh, [db_paths[fi] for fi in chunk],
                budget_bytes if ok else max(budget_bytes - spent, 1), stream=not ok,
            ),
            chunk,
        )
        for chunk, ok in zip(chunked, resident)
    ]


def one_shot_groups(mesh: SearchMesh, db_paths: list[str], budget_bytes: int | None = None):
    """The one-shot search's plan: [(ShardedDatabase, file_indices)] in
    first-appearance order, each BloomParam group cut into chunks of at
    most budget_bytes x the filter shards, and nothing uploaded. A search
    call takes the groups one at a time, so each has the whole budget a
    shard: it uploads the rows its queries touch (the gather route), else
    goes whole if it fits, else streams in its waves."""
    from ..io.dbz_file import open_database

    readers = [open_database(p) for p in db_paths]
    check_device_filter_len(readers)
    if budget_bytes is None:
        budget_bytes = fusion_budget_bytes()
    return [
        (ShardedDatabase.from_files(mesh, [db_paths[fi] for fi in chunk], budget_bytes,
                                    resident=False), chunk)
        for _, chunk in group_file_chunks(readers, budget_bytes * mesh.shape["filters"])
    ]


class _LazyReaders:
    """db_paths[fi] opened at first use."""

    def __init__(self, db_paths: list[str]):
        self._paths = db_paths
        self._open: dict = {}

    def __getitem__(self, fi: int):
        from ..io.dbz_file import open_database

        if fi not in self._open:
            self._open[fi] = open_database(self._paths[fi])
        return self._open[fi]


def search_sharded_groups(
    sharded_groups,
    db_paths: list[str],
    queries: list[tuple[int, str]],
    threshold: float,
    profile: dict | None = None,
):
    """Search prebuilt budget-disciplined groups -> {query_id:
    [MatchResult]}; hit lists identical to the host engine / reference
    binary, including accumulation order (file order, then filter index)
    and the descending stable result sort (output.h:27-32,
    kwage.cpp:190-201). ``profile`` accumulates the keys of
    ``ops.search.search_files_device`` (``ShardedDatabase.counts_cols``;
    ``hits_s``: the hit lists) and ``waves``."""
    from ..search.engine import query_threshold_count

    if not queries:
        return {}
    buckets: dict[int, dict[int, list]] = {}  # qid -> file index -> hits
    qtexts = [q for _, q in queries]
    for sdb, file_idxs in sharded_groups:
        if threshold == 1.0:
            mask, nk = sdb.complete_cols(qtexts, profile)
        else:
            counts, nk = sdb.counts_cols(qtexts, profile)
        t0 = time.perf_counter()
        for qi, (qid, _q) in enumerate(queries):
            if nk[qi] == 0:
                continue
            for (w_lo, w_hi, nf), fi in zip(sdb.file_spans, file_idxs):
                if threshold == 1.0:
                    hits_mask = mask[qi, 32 * w_lo : 32 * w_hi][:nf]
                    hits = [(int(f), int(nk[qi])) for f in np.nonzero(hits_mask)[0]]
                else:
                    c = counts[qi, 32 * w_lo : 32 * w_hi][:nf]
                    qt = query_threshold_count(threshold, int(nk[qi]))
                    hits = [(int(f), int(c[f])) for f in np.nonzero(c >= qt)[0]]
                if hits:
                    buckets.setdefault(qid, {}).setdefault(fi, []).extend(
                        (f, nm, int(nk[qi])) for f, nm in hits
                    )
        if profile is not None:
            _add(profile, "hits_s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    results = collect_results(buckets, _LazyReaders(db_paths), {})
    if profile is not None:
        _add(profile, "hits_s", time.perf_counter() - t0)
    return results


def sharded_search_files(
    mesh: SearchMesh,
    db_paths: list[str],
    queries: list[tuple[int, str]],
    threshold: float,
    budget_bytes: int | None = None,
    profile: dict | None = None,
):
    """Mesh-sharded search over many database files -> {query_id:
    [MatchResult]}, the multi-device counterpart of
    ops.search.search_files_device: one_shot_groups + search_sharded_groups.
    The groups are planned without uploading anything, so each one sees the
    queries first and uploads only the rows they touch where they are few
    (the gather route), else goes whole or in waves. ``profile``: as
    ``search_sharded_groups``.
    """
    if not queries:
        return {}
    groups = one_shot_groups(mesh, db_paths, budget_bytes)
    return search_sharded_groups(groups, db_paths, queries, threshold, profile=profile)
