"""kwage_tpu_torch.ops.search (the port's search reductions and multi-file
search) against the JAX package's kernels and the host engine. Integer
data: every comparison is exact."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kwage_tpu.ops import search as jax_search
from kwage_tpu.pipeline.build_db import transpose_filters
from kwage_tpu_torch.ops import search as ts

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels on the card")
    return torch.device("cuda")


def _inputs(R, W, nq, nk, nh, seed):
    """Random signature matrix, slice indices and a validity mask with
    padding k-mers inside and at the end of each query."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 1 << 32, size=(R, W), dtype=np.uint32)
    idx = rng.integers(0, R, size=(nq, nk, nh), dtype=np.int32)
    valid = rng.random((nq, nk)) < 0.9
    valid[0, 2:] = False           # a query with 2 valid k-mers
    if nq > 1:
        valid[1] = False           # a query with none
    return db, idx, valid


def _rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


@pytest.mark.parametrize("nh", [1, 2, 3, 4, 5])
def test_reductions_match_jax(nh):
    # nk = 45: not a multiple of the 32-k-mer carry-save group.
    db, idx, valid = _inputs(R=256, W=3, nq=4, nk=45, nh=nh, seed=nh)
    args_j = (jnp.asarray(db), jnp.asarray(idx), jnp.asarray(valid))
    args_t = (ts.words_to_tensor(db, CPU), torch.from_numpy(idx), torch.from_numpy(valid))

    want_c = np.asarray(jax_search.search_complete(*args_j))
    np.testing.assert_array_equal(ts.tensor_to_words(ts.complete_ref(*args_t)), want_c)
    np.testing.assert_array_equal(ts.tensor_to_words(ts.search_complete(*args_t)), want_c)

    want_n = np.asarray(jax_search.search_counts(*args_j))
    np.testing.assert_array_equal(ts.counts_ref(*args_t).numpy(), want_n)
    np.testing.assert_array_equal(ts.search_counts(*args_t).numpy(), want_n)


def test_reductions_with_no_kmers():
    db, idx, valid = _inputs(R=64, W=2, nq=3, nk=0, nh=2, seed=0)
    args_t = (ts.words_to_tensor(db, CPU), torch.from_numpy(idx), torch.from_numpy(valid))
    assert (ts.complete_ref(*args_t) == -1).all()
    assert (ts.counts_ref(*args_t) == 0).all()


def test_host_helpers_match_jax():
    rng = np.random.default_rng(4)
    queries = [_rand_seq(rng, 150), _rand_seq(rng, 20), _rand_seq(rng, 400)]
    for got, want in zip(ts.make_query_batch(queries, 31, 3, 12),
                         jax_search.make_query_batch(queries, 31, 3, 12)):
        np.testing.assert_array_equal(got, want)
    slices = rng.integers(0, 256, size=(16, 9), dtype=np.uint8)
    words = ts.db_bytes_to_words(slices)
    np.testing.assert_array_equal(words, jax_search.db_bytes_to_words(slices))
    np.testing.assert_array_equal(ts.unpack_mask(words, 70), jax_search.unpack_mask(words, 70))
    np.testing.assert_array_equal(ts.tensor_to_words(ts.words_to_tensor(words, CPU)), words)


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_eval_chunk_cols_slabs_match_jax(threshold):
    """A budget of 3 columns over a 10-column chunk streams 4 slabs (the
    last one narrower); the result equals the JAX slab path and the
    one-shot resident search."""
    db, idx, valid = _inputs(R=128, W=10, nq=3, nk=40, nh=3, seed=9)
    idx_t, valid_t = torch.from_numpy(idx), torch.from_numpy(valid)
    budget = 128 * 4 * 3
    got = ts.eval_chunk_cols(db[:, :], idx_t, valid_t, threshold, budget)
    want = jax_search.eval_chunk_cols(db, jnp.asarray(idx), jnp.asarray(valid), threshold, budget)
    np.testing.assert_array_equal(got, want)
    resident = ts.eval_chunk_cols(ts.words_to_tensor(db, CPU), idx_t, valid_t, threshold, budget)
    np.testing.assert_array_equal(got, resident)


def _write_db(path, seed, num_filter=40, log2_len=11, num_hash=3):
    from kwage_tpu.core import FilterInfo, str_to_accession
    from kwage_tpu.core.params import BloomParam
    from kwage_tpu.io.db_file import write_db_file

    rng = np.random.default_rng(seed)
    # 1/4 bit density: sparse enough that some queries miss some filters.
    filters = (rng.integers(0, 256, size=(num_filter, (1 << log2_len) // 8), dtype=np.uint8)
               & rng.integers(0, 256, size=(num_filter, (1 << log2_len) // 8), dtype=np.uint8))
    param = BloomParam(kmer_len=31, log_2_filter_len=log2_len, num_hash=num_hash, hash_func=0)
    infos = [FilterInfo(run_accession=str_to_accession(f"SRR{seed * 1000 + i + 1}"))
             for i in range(num_filter)]
    write_db_file(str(path), param, transpose_filters(filters), infos)
    return filters


def test_device_searcher_matches_host_engine(tmp_path):
    from kwage_tpu.io.db_file import DBFileReader
    from kwage_tpu.search.engine import search_database

    path = tmp_path / "t.db"
    _write_db(path, seed=1, num_filter=12, log2_len=10, num_hash=2)
    reader = DBFileReader(str(path))
    searcher, _ = ts.DeviceSearcher.from_file(str(path), CPU)
    rng = np.random.default_rng(5)
    queries = [_rand_seq(rng, 40), _rand_seq(rng, 33), "ACGT"]
    for threshold in (1.0, 0.5, 0.25):
        dev = searcher.search(queries, threshold)
        for qi, q in enumerate(queries):
            assert dev[qi] == search_database(reader, q, threshold), (qi, threshold)


def _fields(results):
    import dataclasses

    return {q: [dataclasses.asdict(m) for m in hits] for q, hits in results.items()}


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_search_files_device_matches_jax(tmp_path, monkeypatch, threshold):
    """Four files of two shapes under a budget that fits two files: several
    fused chunks, one param group split across chunks. Hit lists (order
    included) equal the JAX device search and the host engine."""
    from kwage_tpu.search.engine import search_database_files

    paths = []
    for i, log2_len in enumerate((11, 11, 10, 11)):
        p = tmp_path / f"sra.{i}.db"
        _write_db(p, seed=i + 1, num_filter=40 + 8 * i, log2_len=log2_len)
        paths.append(str(p))
    monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", str(2 * (1 << 11) * 8))
    rng = np.random.default_rng(6)
    queries = list(enumerate([_rand_seq(rng, n) for n in (31, 32, 40, 70, 10)]))
    got = ts.search_files_device(paths, queries, threshold, CPU)
    want = jax_search.search_files_device(paths, queries, threshold)
    host = {q: r for q, r in search_database_files(paths, queries, threshold).items() if r}
    # The port's MatchResult and FilterInfo are its own classes: compare fields.
    assert _fields(got) == _fields(want) == _fields(host)
    assert any(got.values())


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_resident_searcher_spent_budget_streams_in_bounded_slabs(tmp_path, monkeypatch,
                                                                 threshold):
    """Two files of one chunk's size each, the gather route off (every
    host chunk streams whole). A budget of exactly one chunk: a slab's
    share is set aside before the chunks are placed (at these sizes half
    the budget), so a host chunk streams in a bounded number of slabs
    (never one word column a slab). With the share set to a quarter of a
    file (what SLAB_RESERVE_BYTES is to a corpus of real size), a budget of
    a file and a quarter keeps one file resident and streams the other
    within what is left: its slab buffer shares it with the device output
    and a slab's result, so a quarter of a file holds one word column a
    slab, half a file three (t = 1.0) or two (t = 0.5), three quarters
    five or four. The bytes equal the host engine's."""
    from kwage_tpu_torch.search import resident
    from kwage_tpu_torch.search.engine import search_database_files

    paths = []
    for i in range(2):
        p = tmp_path / f"sra.{i}.db"
        _write_db(p, seed=i + 1, num_filter=256, log2_len=10)
        paths.append(str(p))
    chunk_bytes = (1 << 10) * (256 // 32) * 4
    widths = []
    upload = ts.HostChunk.columns

    def recording_columns(self, lo, hi, device, out=None, stager=None):
        widths.append(hi - lo)
        return upload(self, lo, hi, device, out, stager)

    monkeypatch.setattr(ts.HostChunk, "columns", recording_columns)
    monkeypatch.setattr(ts, "GATHER_SHARE", 0.0)
    rng = np.random.default_rng(8)
    seqs = [_rand_seq(rng, n) for n in (31, 40, 70)]
    host = resident.HostResidentSearcher(paths)
    big = ts.SLAB_RESERVE_BYTES
    quarter = chunk_bytes // 4
    half, three_quarters = ([3, 3, 2], [5, 3]) if threshold == 1.0 else ([2] * 4, [4, 4])
    # (budget, the share kept for slabs, resident files, a host file's slab widths)
    for budget, reserve, resident_chunks, slabs in (
            (chunk_bytes, big, 0, [8]), (chunk_bytes * 3 // 2, big, 0, [8]),
            (2 * chunk_bytes, big, 2, []), (3 * chunk_bytes, big, 2, []),
            (chunk_bytes, quarter, 0, [8]), (chunk_bytes + quarter, quarter, 1, [1] * 8),
            (chunk_bytes + 2 * quarter, quarter, 1, half),
            (chunk_bytes + 3 * quarter, quarter, 1, three_quarters)):
        monkeypatch.setattr(ts, "SLAB_RESERVE_BYTES", reserve)
        widths.clear()
        searcher = resident.ResidentSearcher(paths, CPU, budget_bytes=budget)
        assert searcher.resident_bytes == resident_chunks * chunk_bytes
        assert searcher.resident_bytes <= budget
        out = searcher.render(seqs, threshold, "csv")
        assert out == host.render(seqs, threshold, "csv")
        assert widths == slabs * (2 - resident_chunks)
    want = search_database_files(paths, list(enumerate(seqs)), threshold)
    assert _fields(searcher.search(list(enumerate(seqs)), threshold)) == _fields(
        {q: r for q, r in want.items() if r})


# --- the decomposition of csrc/search.cu's chunked search kernels ---

def _kernel_constants() -> dict[str, int]:
    """The block shape of the chunked search kernels, read from the source."""
    path = os.path.join(os.path.dirname(ts.__file__), os.pardir, "csrc", "search.cu")
    with open(path) as f:
        return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}


def _plane_add(acc: list, x: list) -> None:
    """acc += x, numbers in bit planes (plane j: bit j of a uint32 array's
    32 counts), ripple carry, as the kernel's plane_add; acc must hold the
    sum (no carry out of its top plane)."""
    carry = np.zeros_like(acc[0])
    for j in range(len(acc)):
        a, b = acc[j], (x[j] if j < len(x) else np.zeros_like(acc[0]))
        acc[j] = a ^ b ^ carry
        carry = (a & b) | (carry & (a ^ b))
    assert not carry.any()


def _emulate_chunks(db, idx, valid, tcount, order_seed):
    """numpy emulation of the kernels' decomposition, blocks in a random
    order: a block is (query, tile of kTileWords columns, chunk of kWarps x
    kKmersPerWarp k-mer positions); its valid k-mers, compacted, go to warp
    (slot % kWarps); each warp adds its seed-AND words into kWarpPlanes bit
    planes, the block adds the warps' planes into kPlanes and expands them
    to integer counts added into a zeroed [nq, W*32]. With ``tcount``, a
    second pass, a block a (query, tile), compares the tile's complete
    counts and adds its hits to out[q]. -> (counts, out)."""
    c = _kernel_constants()
    warps, per_warp, tile = c["kWarps"], c["kKmersPerWarp"], c["kTileWords"]
    chunk = warps * per_warp
    nq, nk, _ = idx.shape
    W = db.shape[1]
    tiles, chunks = -(-W // tile), -(-nk // chunk)
    counts = np.zeros((nq, W * 32), np.int32)
    out = np.zeros(nq, np.int32)
    bits = np.arange(32, dtype=np.uint32)
    for b in np.random.default_rng(order_seed).permutation(tiles * chunks * nq):
        t, rest = b % tiles, b // tiles
        ch, q = rest % chunks, rest // chunks
        k0, w0 = ch * chunk, t * tile
        w1 = min(w0 + tile, W)
        pos = np.nonzero(valid[q, k0:k0 + chunk])[0]
        if len(pos):
            zeros = lambda n: [np.zeros(w1 - w0, np.uint32) for _ in range(n)]  # noqa: E731
            planes = [zeros(c["kWarpPlanes"]) for _ in range(warps)]
            for s, p in enumerate(pos):
                assert s // warps < per_warp
                m = np.bitwise_and.reduce(db[idx[q, k0 + p], w0:w1], axis=0)
                _plane_add(planes[s % warps], [m])
            total = zeros(c["kPlanes"])
            for w in range(warps):
                _plane_add(total, planes[w])
            expanded = sum(((total[j][:, None] >> bits) & 1).astype(np.int32) << j
                           for j in range(len(total)))
            counts[q, 32 * w0:32 * w1] += expanded.reshape(-1)
    if tcount is not None:
        for b in np.random.default_rng(order_seed + 1).permutation(tiles * nq):
            t, q = b % tiles, b // tiles
            cols = slice(32 * t * tile, 32 * min((t + 1) * tile, W))
            out[q] += int((counts[q, cols] >= tcount[q]).sum())
    return counts, out


def _chunk_inputs(W, nk, holes, seed, R=256, nq=4, nh=5):
    """Queries of nk positions: with ``holes`` the valid flags are random
    (padding inside a query), else each query a valid prefix (nk, about
    half, one, none); query 1 has no valid k-mer either way."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 1 << 32, size=(R, W), dtype=np.uint32)
    idx = rng.integers(0, R, size=(nq, nk, nh), dtype=np.int32)
    if holes:
        valid = rng.random((nq, nk)) < 0.7
    else:
        valid = np.zeros((nq, nk), dtype=bool)
        for q, n in enumerate((nk, 0, 1, (nk + 1) // 2)):
            valid[q, :n] = True
    valid[1] = False
    tcount = np.array([1, 2, max(1, nk // 20), max(1, nk // 40)], dtype=np.int32)
    return db, idx, valid, tcount


@pytest.mark.parametrize("W", [1, 3, 4, 131])
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("nk", [0, 1, 31, 32, 33, 45, 200])
def test_chunk_emulation_matches_refs_and_jax(nk, holes, W):
    """The chunked kernels' decomposition (chunks, carry-save planes a warp
    and a block, the merge in any order, the compare a (query, tile)) gives
    counts_ref's counts and total_hits_ref's totals, and the JAX
    counts_kernel's counts (nk > 0: the JAX kernel reads k-mer 0)."""
    db, idx, valid, tcount = _chunk_inputs(W, nk, holes, seed=nk * 10 + W + holes)
    counts, total = _emulate_chunks(db, idx, valid, tcount, order_seed=nk + W)
    args_t = (ts.words_to_tensor(db, CPU), torch.from_numpy(idx), torch.from_numpy(valid))
    np.testing.assert_array_equal(counts, ts.counts_ref(*args_t).numpy())
    np.testing.assert_array_equal(
        total, ts.total_hits_ref(*args_t, torch.from_numpy(tcount)).numpy())
    if nk:
        want = np.asarray(jax_search.search_counts(jnp.asarray(db), jnp.asarray(idx),
                                                   jnp.asarray(valid)))
        np.testing.assert_array_equal(counts, want)
    if nk >= 32 and not holes:
        assert total[0] > 0 and counts[0].max() > 1   # the thresholds are not vacuous


def _dense(db, seed):
    """Rows whose complete match is not trivial: the low byte of every word
    set (no AND clears it), the other bits at 1 - 2^-4 fill."""
    rng = np.random.default_rng(seed)
    fill = np.bitwise_or.reduce(rng.integers(0, 1 << 32, size=(4, *db.shape), dtype=np.uint32))
    return fill | np.uint32(0xFF)


def _emulate_complete(db, idx, valid, order_seed):
    """numpy emulation of search_complete's decomposition, blocks in a
    random order: a block is (query, tile of kTileWords columns, chunk of
    kWarps x kKmersPerWarp k-mer positions); its valid k-mers, compacted, go
    to warp (slot % kWarps), a slot past them holds all-ones; each warp
    ANDs its slots' seed-AND words, the block ANDs the warps' words, and a
    block with a valid k-mer ANDs the result into out [nq, W], all-ones
    before."""
    c = _kernel_constants()
    warps, per_warp, tile = c["kWarps"], c["kKmersPerWarp"], c["kTileWords"]
    chunk = warps * per_warp
    nq, nk, _ = idx.shape
    W = db.shape[1]
    tiles, chunks = -(-W // tile), -(-nk // chunk)
    out = np.full((nq, W), 0xFFFFFFFF, np.uint32)
    for b in np.random.default_rng(order_seed).permutation(tiles * chunks * nq):
        t, rest = b % tiles, b // tiles
        ch, q = rest % chunks, rest // chunks
        k0, w0 = ch * chunk, t * tile
        w1 = min(w0 + tile, W)
        pos = np.nonzero(valid[q, k0:k0 + chunk])[0]
        if not len(pos):
            continue
        slots = np.full((warps, per_warp, w1 - w0), 0xFFFFFFFF, np.uint32)
        for s, p in enumerate(pos):
            slots[s % warps, s // warps] = np.bitwise_and.reduce(db[idx[q, k0 + p], w0:w1],
                                                                 axis=0)
        warp_words = np.bitwise_and.reduce(slots, axis=1)
        out[q, w0:w1] &= np.bitwise_and.reduce(warp_words, axis=0)
    return out


@pytest.mark.parametrize("W", [1, 3, 4, 131])
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("nk", [0, 1, 31, 32, 33, 45, 200])
def test_complete_emulation_matches_refs_and_jax(nk, holes, W):
    """search_complete's decomposition (chunks, all-ones in the dead slots,
    the AND a warp and a block, the merge into an all-ones output in any
    order) gives complete_ref's mask and the JAX complete_kernel's (nk > 0:
    the JAX kernel reads k-mer 0), and all-ones for query 1, which has no
    valid k-mer. Dense rows, so that the answer is not all zeros."""
    seed = nk * 10 + W + holes
    db, idx, valid, _ = _chunk_inputs(W, nk, holes, seed=seed)
    db = _dense(db, seed)
    got = _emulate_complete(db, idx, valid, order_seed=nk + W)
    args_t = (ts.words_to_tensor(db, CPU), torch.from_numpy(idx), torch.from_numpy(valid))
    np.testing.assert_array_equal(got, ts.tensor_to_words(ts.complete_ref(*args_t)))
    assert (got[1] == 0xFFFFFFFF).all()
    if nk:
        want = np.asarray(jax_search.search_complete(jnp.asarray(db), jnp.asarray(idx),
                                                     jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)
    if valid.any():   # not trivial: words between 0 and all-ones
        assert ((got != 0) & (got != 0xFFFFFFFF)).any()


@pytest.mark.cuda
def test_search_kernels_match_ref(cuda_device):
    for R, W, nq, nk, nh in ((256, 3, 4, 45, 5), (1 << 16, 100, 5, 300, 3)):
        db, idx, valid = _inputs(R, W, nq, nk, nh, seed=R)
        args = (ts.words_to_tensor(db, cuda_device), torch.from_numpy(idx).to(cuda_device),
                torch.from_numpy(valid).to(cuda_device))
        assert torch.equal(ts.search_complete(*args), ts.complete_ref(*args))
        assert torch.equal(ts.search_counts(*args), ts.counts_ref(*args))
    # The chunked kernels' edges: nk around the chunk, holes, a query with
    # no valid k-mer, widths on both load paths (W % 4 == 0 or not); the
    # complete match also on dense rows.
    for W in (1, 3, 4, 131, 512):
        for nk in (0, 1, 31, 32, 33, 45, 200):
            for holes in (False, True):
                db, idx, valid, tcount = _chunk_inputs(W, nk, holes, seed=nk + W)
                args = (ts.words_to_tensor(db, cuda_device),
                        torch.from_numpy(idx).to(cuda_device),
                        torch.from_numpy(valid).to(cuda_device))
                tc = torch.from_numpy(tcount).to(cuda_device)
                assert torch.equal(ts.search_counts(*args), ts.counts_ref(*args))
                assert torch.equal(ts.search_total_hits(*args, tc),
                                   ts.total_hits_ref(*args, tc))
                assert torch.equal(ts.search_complete(*args), ts.complete_ref(*args))
                dense = (ts.words_to_tensor(_dense(db, nk + W), cuda_device), *args[1:])
                assert torch.equal(ts.search_complete(*dense), ts.complete_ref(*dense))
