"""The mesh search's two routes on logical CPU slots (1 x 2, 1 x 4 and 2 x 2
meshes): "gather" (a group that is not resident uploads only the slice
rows a query batch touches, each filter shard its column range of them,
searched with the batch's indices remapped to them) and "full" (every row,
whole or in column waves; ``ops.search.GATHER_SHARE`` set to 0). The
one-shot ``sharded_search_files`` and a ``MeshResidentSearcher`` whose
budget streams some groups give, by either route, the hit lists of the
port's host engine and of the JAX package's ``sharded_search_files`` on its
virtual CPU devices. Integer data: every comparison is exact."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from kwage_tpu.parallel import make_search_mesh as jax_make_search_mesh
from kwage_tpu.parallel import sharded_search as jax_sharded
from kwage_tpu.pipeline.build_db import transpose_filters
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.parallel import mesh as tmesh
from kwage_tpu_torch.parallel import sharded_search as tsh
from kwage_tpu_torch.search.engine import search_database_files
from kwage_tpu_torch.search.resident import MeshResidentSearcher

CPU = torch.device("cpu")
MESHES = [(1, 2), (1, 4), (2, 2)]
MESH_IDS = [f"{d}x{f}" for d, f in MESHES]
SHARE = ts.GATHER_SHARE   # the gather route's share, before a test sets it
PROFILE_KEYS = {"route", "rows", "gather_s", "upload_s", "search_s", "hits_s", "waves"}


def _write(path, seed, num_filter, log2_len, num_hash):
    from kwage_tpu.core import FilterInfo, str_to_accession
    from kwage_tpu.core.params import BloomParam
    from kwage_tpu.io.db_file import write_db_file

    rng = np.random.default_rng(seed)
    # Bit density rising from 1/4 to 15/16 across the filters: some match
    # short queries whole, some miss most k-mers.
    shape = ((1 << log2_len) // 8, 8)
    density = np.linspace(0.25, 0.94, num_filter)
    bits = rng.random((num_filter,) + shape) < density[:, None, None]
    filters = np.packbits(bits, axis=-1, bitorder="little").reshape(num_filter, -1)
    param = BloomParam(kmer_len=31, log_2_filter_len=log2_len, num_hash=num_hash, hash_func=0)
    infos = [FilterInfo(run_accession=str_to_accession(f"SRR{seed * 1000 + i + 1}"))
             for i in range(num_filter)]
    write_db_file(str(path), param, transpose_filters(filters), infos)
    return str(path)


def _corpus(tmp_path, specs=((11, 3, 40), (10, 2, 48), (11, 3, 72), (11, 3, 33))):
    """.db files of two BloomParams by default (L=11 nh=3 x 3 with ragged
    widths, L=10 nh=2 x 1, the params interleaved): two groups at least."""
    return [_write(tmp_path / f"sra.{i}.db", i + 1, nf, log2_len, nh)
            for i, (log2_len, nh, nf) in enumerate(specs)]


def _queries(seed, lengths):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in lengths]
    # No valid k-mer: shorter than k, and all N.
    return list(enumerate(seqs + ["ACGTACGTACGTACGTACGT", "N" * 40]))


def _fields(results):
    return {q: [dataclasses.asdict(m) for m in hits] for q, hits in results.items() if hits}


def _port_mesh(shape):
    return tmesh.make_search_mesh(*shape, [CPU] * (shape[0] * shape[1]))


def _want(paths, queries, threshold, shape, budget):
    """The host engine's hit lists, which the JAX package's mesh search on
    as many virtual devices (under the same budget) must give too."""
    host = _fields(search_database_files(paths, queries, threshold))
    jmesh = jax_make_search_mesh(*shape, jax.devices()[: shape[0] * shape[1]])
    assert _fields(jax_sharded.sharded_search_files(jmesh, paths, queries, threshold,
                                                    budget_bytes=budget)) == host
    return host


@pytest.fixture
def share(monkeypatch):
    """set(x): ``ops.search.GATHER_SHARE`` is x until the test ends."""
    return lambda value: monkeypatch.setattr(ts, "GATHER_SHARE", value)


@pytest.fixture
def streams(monkeypatch):
    """Every ``ShardedDatabase._stream`` call: (group budget a shard,
    gathered, rows of the matrix, its waves, filter shards)."""
    seen = []
    real = tsh.ShardedDatabase._stream

    def recording(self, chunk, waves, *args, **kwargs):
        seen.append((self._budget_bytes, chunk.rows is not None, chunk.shape[0], waves,
                     self.mesh.shape["filters"]))
        return real(self, chunk, waves, *args, **kwargs)

    monkeypatch.setattr(tsh.ShardedDatabase, "_stream", recording)
    return seen


def _planned_shard_bytes(call):
    """Device bytes a shard a ``_stream`` call's buffers take: one buffer
    for a single wave, two for a stream."""
    _, _, rows, waves, n_shards = call
    return rows * (waves[0][2] // n_shards) * 4 * min(len(waves), 2)


@pytest.mark.parametrize("threshold", [1.0, 0.5])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_one_shot_search_by_both_routes(tmp_path, share, streams, shape, threshold):
    """sharded_search_files plans its groups without uploading them; a
    batch under the share uploads only its rows (every group gathers),
    and with GATHER_SHARE at 0 every group goes whole. Both routes give
    the host engine's and the JAX package's hit lists, and the profile
    counts what each call did."""
    paths = _corpus(tmp_path)
    queries = _queries(1, (31, 32, 40, 70))
    mesh = _port_mesh(shape)
    groups = tsh.one_shot_groups(mesh, paths)
    assert len(groups) == 2 and all(sdb.db is None for sdb, _ in groups)
    want = _want(paths, queries, threshold, shape, None)
    assert want
    for route, setting in (("gather", SHARE), ("full", 0.0)):
        share(setting)
        streams.clear()
        prof: dict = {}
        got = tsh.sharded_search_files(mesh, paths, queries, threshold, profile=prof)
        assert _fields(got) == want, route
        assert PROFILE_KEYS <= prof.keys(), prof
        assert prof["route"] == {"gather": 2 if route == "gather" else 0,
                                 "full": 2 if route == "full" else 0}
        assert prof["waves"] == 2 and prof["rows"] > 0
        assert (prof.get("gather_bytes", 0) > 0) == (route == "gather")
        # A group at a time, in order: the gather uploads fewer rows than
        # the files hold, the full route all of them.
        assert len(streams) == len(groups)
        for (_, gathered, rows, _, _), (sdb, _) in zip(streams, groups):
            assert gathered == (route == "gather")
            assert rows < sdb.filter_len if gathered else rows == sdb.filter_len
        if route == "gather":
            assert prof["gather_bytes"] == sum(s[2] * sdb._chunk.shape[1] * 4
                                               for s, (sdb, _) in zip(streams, groups))


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_one_shot_streamed_groups_and_gathered_waves(tmp_path, share, streams, shape):
    """Under a budget that streams the wide groups, their gathered rows
    pass the budget a shard too and go in column waves of their own; both
    routes give the host engine's and the JAX package's hit lists at -t
    1.0 and 0.5, and every planned buffer stays within the budget a shard
    (the full route's within one word column a buffer, its least)."""
    paths = _corpus(tmp_path, ((11, 3, 320), (11, 3, 300), (11, 3, 40)))
    queries = _queries(2, (31, 32, 40, 70, 100))
    mesh = _port_mesh(shape)
    n = shape[1]
    # The wide groups' gathered rows: two buffers of one column a shard
    # fit the budget; a single wave of them would not.
    probe = tsh.one_shot_groups(mesh, paths)
    rows = max(len(sdb._prep([q for _, q in queries]).rows()[0]) for sdb, _ in probe)
    budget = 2 * rows * 4
    groups = tsh.one_shot_groups(mesh, paths, budget)
    assert all(sdb.db is None for sdb, _ in groups)
    assert any(sdb.num_waves > 1 for sdb, _ in groups)
    for threshold in (1.0, 0.5):
        want = _want(paths, queries, threshold, shape, budget)
        for route, setting in (("gather", SHARE), ("full", 0.0)):
            share(setting)
            streams.clear()
            prof: dict = {}
            got = tsh.sharded_search_files(mesh, paths, queries, threshold, budget, prof)
            assert _fields(got) == want, (route, threshold)
            assert prof["route"][route] == len(groups), prof
            gathered = [s for s in streams if s[1]]
            assert len(gathered) == (len(groups) if route == "gather" else 0)
            if route == "gather":
                assert any(len(waves) > 1 for _, _, _, waves, _ in gathered), gathered
                assert prof["waves"] == sum(len(s[3]) for s in streams)
            for s in streams:
                # A call searches its groups one at a time: each has the
                # whole budget.
                assert s[0] == budget, s
                planned = _planned_shard_bytes(s)
                # One word column a shard is the least a wave takes.
                assert planned <= max(s[0], 2 * s[2] * 4) and s[4] == n, (s, planned)
                if s[1]:
                    assert planned <= s[0], (s, planned)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_gathered_waves_count_against_the_share(tmp_path, share, streams, shape):
    """Where the gathered rows themselves pass the budget a shard, each of
    their waves counts: a group gathers while its batch's distinct rows
    times their waves are at most GATHER_SHARE x filter length x the full
    route's waves, and streams in full one row's worth past it, though
    its rows alone stay under the share. Both sides give the host
    engine's hit lists."""
    paths = _corpus(tmp_path, ((11, 3, 620),))
    queries = _queries(7, (31, 40, 70, 100))
    seqs = [q for _, q in queries]
    mesh = _port_mesh(shape)
    (probe, _), = tsh.one_shot_groups(mesh, paths)
    rows = len(probe._prep(seqs).rows()[0])
    budget = 2 * rows * 4   # the gathered rows: one word column a shard a wave
    (sdb, _), = tsh.one_shot_groups(mesh, paths, budget)
    gwaves = len(tsh._wave_plan(rows, sdb._chunk.shape[1], shape[1], budget)[0])
    assert gwaves > 1 and sdb.num_waves > 1
    scale = sdb.filter_len * sdb.num_waves
    want = _fields(search_database_files(paths, queries, 0.5))
    for route, setting in (("gather", (rows * gwaves + 0.5) / scale),
                           ("full", (rows * gwaves - 0.5) / scale)):
        assert rows <= setting * scale   # the rows alone stay under the share
        share(setting)
        streams.clear()
        prof: dict = {}
        got = tsh.sharded_search_files(mesh, paths, queries, 0.5, budget, prof)
        assert _fields(got) == want, route
        assert prof["route"] == {"gather": int(route == "gather"),
                                 "full": int(route == "full")}, prof
        assert [(s[1], len(s[3])) for s in streams] == [
            (True, gwaves) if route == "gather" else (False, sdb.num_waves)]


def _streamed_searcher(paths, shape, monkeypatch):
    """A MeshResidentSearcher over ``paths`` whose budget keeps the first
    chunk resident and streams the others: the waves' share set to a
    quarter of the budget (what SLAB_RESERVE_BYTES is to a corpus of real
    size), the budget three quarters of the corpus a shard."""
    mesh = _port_mesh(shape)
    whole = sum(sdb.wave_shard_bytes for sdb, _ in tsh.build_sharded_groups(mesh, paths))
    budget = whole * 3 // 4
    monkeypatch.setattr(ts, "SLAB_RESERVE_BYTES", budget // 4)
    searcher = MeshResidentSearcher(paths, mesh, budget_bytes=budget)
    resident = [sdb for sdb, _ in searcher.groups if sdb.db is not None]
    streamed = [sdb for sdb, _ in searcher.groups if sdb.db is None]
    assert resident and streamed, [sdb.db is None for sdb, _ in searcher.groups]
    held = sum(sdb.wave_shard_bytes for sdb in resident)
    return searcher, streamed, budget, held


@pytest.mark.parametrize("threshold", [1.0, 0.5])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_mesh_resident_searcher_streamed_groups(tmp_path, monkeypatch, share, streams, shape,
                                                threshold):
    """The resident groups stay on the devices; the streamed ones gather
    the request's rows within what the resident groups left of the budget
    (column waves where they pass it), or with GATHER_SHARE at 0 stream
    every row in waves. Each request's renders and hit lists equal the
    host engine's and the JAX package's; the profile counts the routes."""
    paths = _corpus(tmp_path, ((11, 3, 40), (10, 2, 48), (11, 3, 72), (11, 3, 33),
                               (10, 2, 64)))
    searcher, streamed, budget, held = _streamed_searcher(paths, shape, monkeypatch)
    queries = _queries(3, (31, 32, 40, 70))
    want = _want(paths, queries, threshold, shape, budget)
    uploads = []
    real = tsh._upload_matrix

    def recording(mesh, chunk, *args, **kwargs):
        uploads.append(chunk.shape[0])
        return real(mesh, chunk, *args, **kwargs)

    monkeypatch.setattr(tsh, "_upload_matrix", recording)
    for route, setting in (("gather", SHARE), ("full", 0.0)):
        share(setting)
        streams.clear()
        uploads.clear()
        prof: dict = {}
        got = searcher.search(queries, threshold, prof)
        assert _fields(got) == want, route
        assert prof["route"] == {"gather": len(streamed) if route == "gather" else 0,
                                 "full": len(streamed) if route == "full" else 0,
                                 "resident": len(searcher.groups) - len(streamed)}, prof
        assert len(streams) == len(streamed)
        # Nothing of a resident group is uploaded per request; a gathered
        # group uploads fewer rows than its files hold.
        assert sorted(uploads) == sorted(
            r for _, _, r, waves, _ in streams for _ in waves)
        assert all(gathered == (route == "gather") and
                   (rows < sdb.filter_len) == gathered
                   for (_, gathered, rows, _, _), sdb in zip(streams, streamed))
        for s in streams:
            assert s[0] == budget - held
            planned = _planned_shard_bytes(s)
            assert held + planned <= budget or not s[1] and planned <= 2 * s[2] * 4, s
    seqs = [q for _, q in queries]
    out = searcher.render(seqs, threshold, "csv")
    share(0.0)
    assert searcher.render(seqs, threshold, "csv") == out


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_streamed_group_just_under_and_just_over_the_share(tmp_path, monkeypatch, share, shape):
    """A streamed group takes the gather route while the batch's distinct
    rows are at most GATHER_SHARE x its filter length x its waves, the full
    route one row past it: the same counts, masks and totals either side,
    and the searcher's hit lists those of the host engine and the JAX
    package at -t 1.0 and 0.5."""
    paths = _corpus(tmp_path, ((11, 3, 40), (10, 2, 48), (11, 3, 72), (11, 3, 33),
                               (10, 2, 64)))
    searcher, streamed, budget, _ = _streamed_searcher(paths, shape, monkeypatch)
    queries = _queries(4, (31, 40, 90, 120))
    seqs = [q for _, q in queries]
    want = {t: _want(paths, queries, t, shape, budget) for t in (1.0, 0.5)}
    for sdb in streamed:
        rows = len(sdb._prep(seqs).rows()[0])
        scale = sdb.filter_len * sdb.num_waves
        results = {}
        for route, setting in (("gather", (rows + 0.5) / scale), ("full", (rows - 0.5) / scale)):
            share(setting)
            prof: dict = {}
            counts, nk = sdb.counts_cols(seqs, prof)
            mask, nk2 = sdb.complete_cols(seqs, prof)
            totals = [sdb.total_hits(seqs, t, prof) for t in (1.0, 0.5)]
            assert prof["route"] == {"gather": 4 if route == "gather" else 0,
                                     "full": 4 if route == "full" else 0}, prof
            assert prof["rows"] == 4 * rows
            results[route] = (counts, mask, totals, nk, nk2)
            for t in (1.0, 0.5):
                assert _fields(searcher.search(queries, t)) == want[t], (route, t)
        for a, b in zip(results["gather"], results["full"]):
            if isinstance(a, list):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a, b)
        assert results["full"][0].any()


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_total_hits_equal_the_hit_list_lengths(tmp_path, monkeypatch, share, shape):
    """Summed over a searcher's groups (resident, gathered or streamed in
    full), total_hits is each query's hit-list length at -t 1.0 and 0.5
    (less the hits of no k-mer found); the one-shot plan's groups the
    same."""
    paths = _corpus(tmp_path, ((11, 3, 40), (10, 2, 48), (11, 3, 72), (11, 3, 33),
                               (10, 2, 64)))
    searcher, _, _, _ = _streamed_searcher(paths, shape, monkeypatch)
    one_shot = tsh.one_shot_groups(_port_mesh(shape), paths)
    queries = _queries(5, (31, 32, 40, 70, 150))
    seqs = [q for _, q in queries]
    for threshold in (1.0, 0.5):
        want = search_database_files(paths, queries, threshold)
        # A query's threshold count is at least 1 in total_hits (so that
        # zero padding columns never count, as in the JAX package): a
        # 1-k-mer query at -t 0.5 lists every filter, total_hits those
        # with its k-mer.
        lengths = [sum(m.num_kmers_found >= 1 for m in want.get(i, []))
                   for i in range(len(seqs))]
        assert any(lengths)
        for setting in (SHARE, 0.0):
            share(setting)
            for groups in (searcher.groups, one_shot):
                got = sum(sdb.total_hits(seqs, threshold) for sdb, _ in groups)
                assert got.tolist() == lengths, (threshold, setting)


def test_kwage_cli_on_several_slots_by_both_routes(tmp_path, monkeypatch, capsys, share):
    """kwage --device with 4 logical CPU slots visible runs the one-shot
    mesh search (cli/kwage.py's several-card branch); by either route its
    output is the host engine's, byte for byte."""
    from kwage_tpu_torch.cli.kwage import main

    paths = _corpus(tmp_path)
    seqs = [q for _, q in _queries(6, (31, 40, 70))]
    base = [a for p in paths for a in ("-d", p)]
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tmesh, "default_devices", lambda: [CPU] * 4)
    calls = []
    real = tsh.sharded_search_files

    def recording(mesh, *args, **kwargs):
        prof: dict = {}
        calls.append((mesh.shape, prof))
        return real(mesh, *args, **kwargs, profile=prof)

    monkeypatch.setattr(tsh, "sharded_search_files", recording)
    for threshold, fmt in ((1.0, "csv"), (0.5, "json")):
        args = base + ["-t", str(threshold), f"--o.{fmt}"]
        assert main(args + seqs) == 0
        host = capsys.readouterr().out
        assert "SRR" in host
        for route, setting in (("gather", SHARE), ("full", 0.0)):
            share(setting)
            calls.clear()
            assert main(args + ["--device"] + seqs) == 0
            assert capsys.readouterr().out == host, (route, threshold)
            assert [(s, p["route"][route]) for s, p in calls] == [
                ({"data": 1, "filters": 4}, 2)]


def test_search_routes_program_times_the_mesh_on_the_cpu(tmp_path, monkeypatch):
    """bench.search_routes --mesh 2: beside each search_files_device call,
    the one-shot mesh search on 2 logical slots by the same route, with
    the same hits and its own profile; by the "rule" route, the one the
    single card's rule took."""
    from kwage_tpu_torch.bench import search_routes

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    out = tmp_path / "routes.json"
    assert search_routes.main(["--work", str(tmp_path / "w"), "--log2-len", "14", "--files",
                               "2", "--shares", "0.02,0.6", "--calls", "1", "--mesh", "2",
                               "--out", str(out)]) == 0
    lines = json.loads(out.read_text())
    calls = [r for r in lines if r["phase"] == "call"]
    mesh_calls = [r for r in lines if r["phase"] == "mesh_call"]
    assert [(r["share_target"], r["route"], r["taken"]) for r in mesh_calls] == [
        (r["share_target"], r["route"], r["taken"]) for r in calls]
    for single, mesh in zip(calls, mesh_calls):
        assert mesh["hits"] == single["hits"] > 0 and mesh["mesh"] == 2
        assert mesh["taken"] == (single["taken"] if mesh["route"] == "rule" else mesh["route"])
        assert mesh["steps"]["route"][mesh["taken"]] == 1
        assert PROFILE_KEYS <= mesh["steps"].keys()
