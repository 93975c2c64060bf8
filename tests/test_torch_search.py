"""kwage_tpu_torch.ops.search (the port's search reductions and multi-file
search) against the JAX package's kernels and the host engine. Integer
data: every comparison is exact."""

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


@pytest.mark.cuda
def test_search_kernels_match_ref(cuda_device):
    for R, W, nq, nk, nh in ((256, 3, 4, 45, 5), (1 << 16, 100, 5, 300, 3)):
        db, idx, valid = _inputs(R, W, nq, nk, nh, seed=R)
        args = (ts.words_to_tensor(db, cuda_device), torch.from_numpy(idx).to(cuda_device),
                torch.from_numpy(valid).to(cuda_device))
        assert torch.equal(ts.search_complete(*args), ts.complete_ref(*args))
        assert torch.equal(ts.search_counts(*args), ts.counts_ref(*args))
