"""The port's multi-file device search by its two routes: "gather" (only
the slice rows a query batch touches go to the device, searched with the
batch's indices remapped to them) and "full" (the whole chunk, in
overlapped column slabs when it passes the budget). Every hit list equals
the JAX device search and the host engine exactly."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kwage_tpu.ops import search as jax_search
from kwage_tpu.pipeline.build_db import transpose_filters
from kwage_tpu.search.engine import search_database_files
from kwage_tpu_torch.io.dbz_file import open_database
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.search.resident import ResidentSearcher

CPU = torch.device("cpu")


def _filters(seed, num_filter, log2_len):
    rng = np.random.default_rng(seed)
    # 1/4 bit density: sparse enough that some queries miss some filters.
    shape = (num_filter, (1 << log2_len) // 8)
    return (rng.integers(0, 256, size=shape, dtype=np.uint8)
            & rng.integers(0, 256, size=shape, dtype=np.uint8))


def _write(path, seed, num_filter, log2_len, num_hash, dbz=False):
    from kwage_tpu.core import FilterInfo, str_to_accession
    from kwage_tpu.core.params import BloomParam
    from kwage_tpu.io.db_file import write_db_file
    from kwage_tpu.io.dbz_file import write_dbz_file_streaming

    param = BloomParam(kmer_len=31, log_2_filter_len=log2_len, num_hash=num_hash, hash_func=0)
    infos = [FilterInfo(run_accession=str_to_accession(f"SRR{seed * 1000 + i + 1}"))
             for i in range(num_filter)]
    slices = transpose_filters(_filters(seed, num_filter, log2_len))
    if dbz:
        write_dbz_file_streaming(str(path), param, [slices], infos, num_filter, chunk_rows=256)
    else:
        write_db_file(str(path), param, slices, infos)
    return str(path)


def _corpus(tmp_path, dbz=False):
    """Four files of two BloomParams (L=11 nh=3 x 3 with ragged widths,
    L=10 nh=2 x 1): two groups, two row sets; the third file a .dbz when
    ``dbz``."""
    specs = [(11, 3, 40), (10, 2, 48), (11, 3, 72), (11, 3, 33)]
    return [_write(tmp_path / f"sra.{i}.{'dbz' if dbz and i == 2 else 'db'}", i + 1, nf,
                   log2_len, nh, dbz=dbz and i == 2)
            for i, (log2_len, nh, nf) in enumerate(specs)]


def _queries(seed, lengths):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in lengths]
    # No valid k-mer: shorter than k, and all N.
    return list(enumerate(seqs + ["ACGTACGTACGTACGTACGT", "N" * 40]))


def _fields(results):
    return {q: [dataclasses.asdict(m) for m in hits] for q, hits in results.items() if hits}


def _want(paths, queries, threshold):
    want = jax_search.search_files_device(paths, queries, threshold)
    host = search_database_files(paths, queries, threshold)
    assert _fields(want) == _fields(host)
    return _fields(host)


# (case, dbz, budget in bytes or None for the default, query lengths,
#  routes {"gather": chunks, "full": chunks}, whether some chunk streams)
CASES = [
    ("gather", False, None, (31, 32, 40, 70), {"gather": 2, "full": 0}, False),
    # Budget of 1 KiB: chunks of one file each, every gathered chunk wider
    # than the budget streams in column slabs.
    ("gather_streamed", False, 1 << 10, (31, 32, 40, 70), {"gather": 4, "full": 0}, True),
    ("dbz", True, None, (31, 32, 40, 70), {"gather": 2, "full": 0}, False),
    # 430 bp: 55% of the L=10 group's rows, 44% of the L=11 group's.
    ("full", False, None, (31, 430), {"gather": 0, "full": 2}, False),
    ("full_streamed", True, 1 << 13, (31, 2000), None, True),
    # 400 bp: past GATHER_SHARE of each group's rows, so whole chunks take
    # the full route. Under 1 KiB the full route streams each file in 2-3
    # column slabs of one word, and so do the gathered rows (42% of the L=11
    # files' rows, 52% of the L=10 file's), each slab gathering them again:
    # every file takes the full route.
    ("past_share", False, None, (31, 400), {"gather": 0, "full": 2}, False),
    ("past_share_slabs", False, 1 << 10, (31, 400), {"gather": 0, "full": 4}, True),
    # 250 bp: 27% of the L=11 files' rows, 34% of the L=10 file's, under
    # the share for each of the full route's 2-3 slabs but past it once the
    # gathered rows' own 2-3 slabs are counted: the full route, file by file.
    ("gathered_slabs_past_share", False, 1 << 10, (31, 250), {"gather": 0, "full": 4}, True),
]


@pytest.mark.parametrize("threshold", [1.0, 0.5])
@pytest.mark.parametrize("case,dbz,budget,lengths,routes,streams", CASES,
                         ids=[c[0] for c in CASES])
def test_search_files_device_routes(tmp_path, monkeypatch, case, dbz, budget, lengths,
                                    routes, streams, threshold):
    if budget is not None:
        monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", str(budget))
    paths = _corpus(tmp_path, dbz)
    queries = _queries(len(lengths), lengths)
    prof: dict = {}
    got = ts.search_files_device(paths, queries, threshold, CPU, profile=prof)
    assert _fields(got) == _want(paths, queries, threshold)
    assert any(got.values())
    if routes is not None:
        assert prof["route"] == routes
    else:
        assert prof["route"]["full"] >= 1
    assert (prof.get("slabs", 0) > 0) == streams
    assert (prof.get("gather_bytes", 0) > 0) == (prof["route"]["gather"] > 0)
    if prof["route"]["gather"]:
        assert prof["rows"] > 0 and prof["gather_s"] >= 0


def test_gather_rows_cover_the_batch_and_its_padding():
    """The batch's distinct rows are sorted, hold row 0 of the padding
    k-mers, and remap every index exactly; a query with no valid k-mer
    adds only padding."""
    from kwage_tpu_torch.core.params import BloomParam

    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=4, hash_func=0)
    seqs = [q for _, q in _queries(3, (40, 300))]
    batch = ts.QueryBatch(seqs, param, CPU)
    rows, local = batch.rows()
    assert rows[0] == 0 and (np.diff(rows) > 0).all()
    np.testing.assert_array_equal(rows[local], batch.idx)
    assert batch.nk[-1] == batch.nk[-2] == 0
    # The gather route up to GATHER_SHARE of the filter length.
    least = int(np.ceil(len(rows) / ts.GATHER_SHARE))
    assert batch.gathers(least) and not batch.gathers(least - 1)
    # ... for each column slab the full route would read the chunk in.
    least = int(np.ceil(len(rows) / (3 * ts.GATHER_SHARE)))
    assert batch.gathers(least, 3) and not batch.gathers(least - 1, 3)


@pytest.mark.parametrize("gathered_passes", [2, 3, 5])
def test_gathers_counts_the_gathered_rows_slabs(gathered_passes):
    """QueryBatch.gathers counts the gathered rows once for each slab they
    take themselves: the rows times their slabs at most GATHER_SHARE of
    the filter length times the full route's slabs."""
    from kwage_tpu_torch.core.params import BloomParam

    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=4, hash_func=0)
    batch = ts.QueryBatch([q for _, q in _queries(3, (40, 300))], param, CPU)
    U = len(batch.rows()[0])
    for passes in (gathered_passes, 4 * gathered_passes):
        least = int(np.ceil(U * gathered_passes / (passes * ts.GATHER_SHARE)))
        assert batch.gathers(least, passes, gathered_passes)
        assert not batch.gathers(least - 1, passes, gathered_passes)
        # One slab of gathered rows is the rule without them.
        assert batch.gathers(least - 1, passes)


@pytest.mark.parametrize("stage_bytes", [7, 100, 1 << 20])
@pytest.mark.parametrize("gathered", [False, True])
def test_host_chunk_columns_through_staged_blocks(stage_bytes, gathered):
    """HostChunk.columns through a stager of ``stage_bytes`` (one row a
    block, several rows, everything at once), whole rows or gathered
    ones, word ranges inside and across files with a ragged last word:
    the bytes of the same columns of the joined matrix (pad bytes 0)."""
    rng = np.random.default_rng(stage_bytes)
    pieces = [rng.integers(0, 256, size=(64, n), dtype=np.uint8) for n in (5, 8, 3)]
    joined = np.hstack([np.pad(p, ((0, 0), (0, -p.shape[1] % 4))) for p in pieces])
    rows = np.unique(rng.integers(0, 64, size=30)) if gathered else None
    want = joined.view(np.uint32)[rows if gathered else slice(None)]
    chunk = ts.HostChunk(pieces, rows)
    assert chunk.shape == want.shape
    W = want.shape[1]
    for lo, hi in ((0, W), (0, 1), (1, 3), (W - 1, W)):
        with ts.PinnedStager(CPU, nbytes=stage_bytes) as stager:
            got = chunk.columns(lo, hi, CPU, stager=stager)
            stager.finish()
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want[:, lo:hi])


@pytest.mark.parametrize("threshold", [1.0, 0.5])
@pytest.mark.parametrize("budget_words", [1, 2, 5, 100])
def test_eval_chunk_cols_gathered_equals_full(threshold, budget_words):
    """A chunk's gathered rows searched with the remapped indices give the
    full chunk's result, streamed in slabs, in one piece, or uploaded
    first and searched on the device."""
    rng = np.random.default_rng(budget_words)
    pieces = [rng.integers(0, 256, size=(512, n), dtype=np.uint8) for n in (12, 7)]
    idx = rng.integers(0, 512, size=(3, 40, 3), dtype=np.int32)
    valid = rng.random((3, 40)) < 0.8
    valid[1] = False
    rows, inv = np.unique(idx, return_inverse=True)
    local = inv.reshape(idx.shape).astype(np.int32)
    valid_t = torch.from_numpy(valid)
    full = ts.eval_chunk_cols(ts.HostChunk(pieces), torch.from_numpy(idx), valid_t,
                              threshold, 1 << 30)
    gathered = ts.HostChunk(pieces, rows)
    budget = budget_words * len(rows) * 4
    got = ts.eval_chunk_cols(gathered, torch.from_numpy(local), valid_t, threshold, budget)
    np.testing.assert_array_equal(got, full)
    resident = gathered.columns(0, gathered.shape[1], CPU)
    np.testing.assert_array_equal(
        ts.eval_chunk_cols(resident, torch.from_numpy(local), valid_t, threshold, budget), full)


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_resident_searcher_streamed_group_gathers(tmp_path, monkeypatch, threshold):
    """A ResidentSearcher that keeps one chunk resident and the others on
    the host gathers the host chunks' rows per request (within the budget
    the resident chunk left); its hit lists equal search_files_device's,
    the JAX device search's and the host engine's."""
    paths = _corpus(tmp_path, dbz=True)
    gathers = []
    real = ts.eval_chunk_cols

    def counting(words, *args, **kwargs):
        if isinstance(words, ts.HostChunk) and words.rows is not None:
            gathers.append(words.shape)
        return real(words, *args, **kwargs)

    monkeypatch.setattr(ts, "eval_chunk_cols", counting)
    smallest = min(ts.HostChunk([ts._slices(open_database(p))]).nbytes for p in paths)
    searcher = ResidentSearcher(paths, CPU, budget_bytes=2 * smallest)
    hosted = [db for _, db, _ in searcher._groups if isinstance(db, ts.HostChunk)]
    assert 0 < searcher.resident_bytes and hosted
    queries = _queries(4, (31, 32, 40, 70))
    got = searcher.search(queries, threshold)
    assert len(gathers) == len(hosted)
    assert all(rows < db.shape[0] for (rows, _), db in zip(gathers, hosted))
    want = _want(paths, queries, threshold)
    assert _fields(got) == want == _fields(ts.search_files_device(paths, queries, threshold,
                                                                   CPU))


def test_search_routes_program_on_the_cpu(tmp_path, monkeypatch):
    """bench.search_routes whole on the CPU at L=14 over 2 linked files:
    a line a call for each route at each share, the batch's rows near the
    share asked for, the same hits by every route and the host engine; the
    "rule" route gathers 2% of the rows and sends 60% by the full route."""
    from kwage_tpu_torch.bench import search_routes

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    out = tmp_path / "routes.json"
    assert search_routes.main(["--work", str(tmp_path / "w"), "--log2-len", "14", "--files",
                               "2", "--shares", "0.02,0.6", "--calls", "1", "--host",
                               "--out", str(out)]) == 0
    lines = json.loads(out.read_text())
    calls = [r for r in lines if r["phase"] == "call"]
    assert [(r["share_target"], r["route"], r["taken"]) for r in calls] == [
        (0.02, "gather", "gather"), (0.02, "full", "full"), (0.02, "rule", "gather"),
        (0.6, "gather", "gather"), (0.6, "full", "full"), (0.6, "rule", "full")]
    for r in calls:
        assert abs(r["share"] - r["share_target"]) < 0.1 and r["hits"] > 0
        assert r["steps"]["route"][r["taken"]] == 1
    assert len({r["hits"] for r in calls[:3]}) == len({r["hits"] for r in calls[3:]}) == 1
    assert [r["phase"] for r in lines][:3] == ["h2d", "corpus", "host"]
