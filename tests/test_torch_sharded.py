"""kwage_tpu_torch.parallel (mesh, sharded_search) against kwage_tpu's mesh
search on its 8 virtual CPU devices, the port's single-device search and the
port's host engine. The port's mesh is 8 logical shards on the CPU, so every
kernel wrapper runs its plain version. Integer data: every comparison is
exact."""

import dataclasses
import json
import os
import socket
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

import jax

from kwage_tpu.core.params import BloomParam
from kwage_tpu.ops.search import make_query_batch as jax_make_query_batch
from kwage_tpu.parallel import ShardedDatabase as JaxShardedDatabase
from kwage_tpu.parallel import make_search_mesh as jax_make_search_mesh
from kwage_tpu.parallel import sharded_search as jax_sharded
from kwage_tpu.pipeline.build_db import transpose_filters
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.parallel import mesh as tmesh
from kwage_tpu_torch.parallel import sharded_search as tsh

CPU = torch.device("cpu")
MESHES = [(1, 8), (2, 4), (8, 1)]

rng = np.random.default_rng(21)


def rand_seq(n):
    return "".join(rng.choice(list("ACGT")) for _ in range(n))


def port_mesh(num_data, num_filter_shards):
    return tmesh.make_search_mesh(num_data, num_filter_shards,
                                  [CPU] * (num_data * num_filter_shards))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corpus():
    num_filter, L = 512, 4096  # 16 packed words -> 2 words per filter shard
    filters = rng.integers(0, 256, size=(num_filter, L // 8), dtype=np.uint8)
    slices = transpose_filters(filters)
    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=3, hash_func=0)
    return param, slices, num_filter


def _fields(results):
    return {q: [dataclasses.asdict(m) for m in hits] for q, hits in results.items()}


def _triples(results):
    return {q: [(m.num_kmers_found, m.num_query_kmer, int(m.subject_info.run_accession))
                for m in hits] for q, hits in results.items()}


def test_mesh_shape_and_argument_check():
    mesh = port_mesh(2, 4)
    assert mesh.shape == {"data": 2, "filters": 4} and mesh.size == 8
    assert mesh.axis_names == ("data", "filters")
    assert not mesh.spans_processes and len(mesh.local_slots()) == 8
    assert tmesh.make_search_mesh(2, None, [CPU] * 6).shape["filters"] == 3
    with pytest.raises(ValueError, match="mesh 3x3 != 8 devices"):
        tmesh.make_search_mesh(3, 3, [CPU] * 8)
    with pytest.raises(ValueError) as jax_err:
        jax_make_search_mesh(3, 3)
    with pytest.raises(ValueError) as port_err:
        tmesh.make_search_mesh(3, 3, [CPU] * len(jax.devices()))
    assert str(port_err.value) == str(jax_err.value)


def test_default_devices_follow_the_environment(monkeypatch):
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    assert tmesh.default_devices() == [CPU]
    assert tmesh.make_search_mesh().shape == {"data": 1, "filters": 1}
    # The default mesh takes whatever devices are visible.
    monkeypatch.setattr(tmesh, "default_devices", lambda: [CPU] * 4)
    assert tmesh.make_search_mesh(2).shape == {"data": 2, "filters": 2}


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_functions_match_jax(corpus, mesh_shape):
    """sharded_search_counts / _complete / sharded_total_hits on the same
    arrays as the JAX functions: the same global arrays."""
    param, slices, _ = corpus
    words = ts.db_bytes_to_words(slices)
    queries = [rand_seq(100), rand_seq(200), rand_seq(64), rand_seq(31),
               rand_seq(90), rand_seq(10), rand_seq(150), rand_seq(33)]
    idx, valid, nk = jax_make_query_batch(queries, param.kmer_len, param.num_hash,
                                          param.log_2_filter_len)
    tcount = np.maximum((nk * 0.3).astype(np.int32), 1)
    jmesh = jax_make_search_mesh(*mesh_shape)
    mesh = port_mesh(*mesh_shape)
    db = tsh.place_matrix(mesh, words)
    for name in ("sharded_search_counts", "sharded_search_complete"):
        want = jax_sharded.to_host(getattr(jax_sharded, name)(jmesh, words, idx, valid))
        got = tsh.to_host(getattr(tsh, name)(mesh, db, idx, valid))
        np.testing.assert_array_equal(got.view(want.dtype), want)
    want = jax_sharded.to_host(jax_sharded.sharded_total_hits(jmesh, words, idx, valid, tcount))
    got = tsh.to_host(tsh.sharded_total_hits(mesh, words, idx, valid, tcount))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.sum() > 0
    # One device, one call: the wrapper the shards run.
    single = ts.search_total_hits(ts.words_to_tensor(words, CPU), torch.from_numpy(idx),
                                  torch.from_numpy(valid), torch.from_numpy(tcount))
    np.testing.assert_array_equal(single.numpy(), want)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_matches_single_device(corpus, mesh_shape):
    param, slices, num_filter = corpus
    sdb = tsh.ShardedDatabase(port_mesh(*mesh_shape), param, slices, num_filter)
    jdb = JaxShardedDatabase(jax_make_search_mesh(*mesh_shape), param, slices, num_filter)
    assert (sdb.num_waves, sdb.num_cols, sdb.W) == (jdb.num_waves, jdb.num_cols, jdb.W)
    queries = [rand_seq(100), rand_seq(200), rand_seq(64)]

    # Reference: the port's single-device wrappers.
    db = ts.words_to_tensor(ts.db_bytes_to_words(slices), CPU)
    idx, valid, nk = ts.make_query_batch(queries, param.kmer_len, param.num_hash,
                                         param.log_2_filter_len)
    idx_t, valid_t = torch.from_numpy(idx), torch.from_numpy(valid)
    want_counts = ts.search_counts(db, idx_t, valid_t).numpy()[:, :num_filter]
    want_mask = ts.unpack_mask(ts.tensor_to_words(ts.search_complete(db, idx_t, valid_t)),
                               num_filter)

    got_counts, got_nk = sdb.search_counts(queries)
    got_mask, _ = sdb.search_complete(queries)
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got_nk, nk)
    jax_counts, _ = jdb.search_counts(queries)
    jax_mask, _ = jdb.search_complete(queries)
    np.testing.assert_array_equal(got_counts, jax_counts)
    np.testing.assert_array_equal(got_mask, jax_mask)


def test_global_mesh_and_inventory_sharding():
    from kwage_tpu_torch.parallel import make_global_search_mesh, shard_inventory
    from kwage_tpu_torch.parallel import maestro as tmaestro

    mesh = make_global_search_mesh(local_devices=[CPU] * 8)
    assert set(mesh.axis_names) == {"data", "filters"}
    assert mesh.size == 8 and mesh.shape == {"data": 1, "filters": 8}
    assert make_global_search_mesh(2, [CPU] * 8).shape == {"data": 2, "filters": 4}
    with pytest.raises(ValueError, match="8 devices not divisible into 3 data shards"):
        make_global_search_mesh(3, [CPU] * 8)
    # Equal chunks, remainder to the last host (sra_stream.cpp:525-543);
    # one definition, in the scheduler's module.
    assert shard_inventory is tmaestro.shard_inventory
    spans = [shard_inventory(10, r, 3) for r in range(3)]
    assert spans == [(0, 3), (3, 6), (6, 10)]


def test_init_distributed_single_process(monkeypatch):
    from kwage_tpu_torch.parallel import init_distributed

    for name in ("KWAGE_COORDINATOR_ADDRESS", "KWAGE_NUM_PROCESSES", "KWAGE_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    with pytest.raises(ValueError):
        init_distributed("localhost:1", 2, None)


def test_total_hits_matches_counts():
    """The totals summed over the shards equal the brute count from the
    full sharded hit matrix, and the JAX psum's."""
    from kwage_tpu_torch.search.engine import query_threshold_count

    lrng = np.random.default_rng(12)
    L, F = 1 << 12, 32 * 8
    filters_arr = lrng.integers(0, 256, size=(F, L // 8), dtype=np.uint8)
    slices = transpose_filters(filters_arr)
    param = BloomParam(kmer_len=31, log_2_filter_len=12, num_hash=3, hash_func=0)
    sdb = tsh.ShardedDatabase(port_mesh(2, 4), param, slices, F)
    jdb = JaxShardedDatabase(jax_make_search_mesh(2, 4), param, slices, F)

    queries = ["".join(lrng.choice(list("ACGT"), size=70)) for _ in range(3)]
    threshold = 0.3
    totals = sdb.total_hits(queries, threshold)
    counts, nk = sdb.search_counts(queries)
    for qi in range(len(queries)):
        qt = max(query_threshold_count(threshold, int(nk[qi])), 1)
        assert totals[qi] == int((counts[qi] >= qt).sum()), qi
    np.testing.assert_array_equal(totals, jdb.total_hits(queries, threshold))
    assert totals.sum() > 0


@pytest.mark.parametrize("mesh_shape,budget", [((8, 1), 16384), ((1, 8), 4096), ((2, 4), 8192)])
def test_budget_waves_match_unbudgeted(corpus, mesh_shape, budget, monkeypatch):
    """A per-shard budget far smaller than the corpus forces multi-wave
    streaming; counts, complete masks and totals must be identical to the
    fully-resident path and to the JAX class under the same budget, wave
    for wave. A stream never holds a third wave: every wave's shards lie
    in one of two buffers. (The full route: GATHER_SHARE 0.)"""
    monkeypatch.setattr(ts, "GATHER_SHARE", 0.0)
    param, slices, num_filter = corpus
    mesh = port_mesh(*mesh_shape)
    resident = tsh.ShardedDatabase(mesh, param, slices, num_filter)
    waved = tsh.ShardedDatabase(mesh, param, slices, num_filter, budget_bytes=budget)
    jwaved = JaxShardedDatabase(jax_make_search_mesh(*mesh_shape), param, slices, num_filter,
                                budget_bytes=budget)
    assert waved.num_waves > 1, "budget did not force multiple waves"
    assert waved.db is None  # nothing stays resident
    assert (waved.num_waves, waved.W) == (jwaved.num_waves, jwaved.W)
    # Half the budget a wave, or the floor of one word column a shard.
    assert waved.wave_shard_bytes <= max(budget // 2, 4096 * 4)

    seen = {}
    upload = tsh._upload_matrix

    def recording_upload(*args, **kwargs):
        db = upload(*args, **kwargs)
        for key, t in db.shards.items():
            seen.setdefault(key, set()).add(t.data_ptr())
        return db

    monkeypatch.setattr(tsh, "_upload_matrix", recording_upload)
    queries = [rand_seq(100), rand_seq(200), rand_seq(64)]
    want_counts, _ = resident.search_counts(queries)
    got_counts, _ = waved.search_counts(queries)
    assert all(len(ptrs) <= 2 for ptrs in seen.values()) and seen
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got_counts, jwaved.search_counts(queries)[0])

    want_mask, _ = resident.search_complete(queries)
    got_mask, _ = waved.search_complete(queries)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got_mask, jwaved.search_complete(queries)[0])

    np.testing.assert_array_equal(
        waved.total_hits(queries, 0.3), resident.total_hits(queries, 0.3)
    )
    np.testing.assert_array_equal(
        waved.total_hits(queries, 0.3), jwaved.total_hits(queries, 0.3)
    )


def _mk_db(path, lrng, param, nf, acc0):
    from kwage_tpu_torch.core import FilterInfo, str_to_accession
    from kwage_tpu_torch.io.db_file import write_db_file

    slices = lrng.integers(0, 256, size=(param.filter_len, (nf + 7) // 8), dtype=np.uint8)
    infos = [FilterInfo(run_accession=str_to_accession(f"SRR4{acc0 + i:06d}"))
             for i in range(nf)]
    write_db_file(str(path), param, slices, infos)
    return str(path)


def _peak_shard_bytes(groups):
    """Resident bytes a shard plus the two transient waves of the widest
    streaming group."""
    resident = sum(sdb.wave_shard_bytes for sdb, _ in groups if sdb.db is not None)
    waves = max((2 * sdb.wave_shard_bytes for sdb, _ in groups if sdb.db is None), default=0)
    return resident + waves


def test_budget_shared_across_groups(tmp_path, monkeypatch):
    """Resident groups claim from ONE budget pool; streaming groups size
    waves within the remainder. Hit lists equal the host engine's and the
    JAX mesh's. (The full route: GATHER_SHARE 0.)"""
    from kwage_tpu.search.engine import search_database_files as jax_host_search
    from kwage_tpu_torch.core.params import BloomParam as PortParam
    from kwage_tpu_torch.search.engine import search_database_files

    monkeypatch.setattr(ts, "GATHER_SHARE", 0.0)

    param = PortParam(kmer_len=31, log_2_filter_len=12, num_hash=3, hash_func=0)
    lrng = np.random.default_rng(5)
    small = _mk_db(tmp_path / "small.db", lrng, param, 64, 0)      # 2 packed words wide
    big = _mk_db(tmp_path / "big.db", lrng, param, 4096, 1000)     # 128 words wide
    files = [small, big]
    n_shards = 8
    mesh = port_mesh(1, n_shards)
    budget = 68 << 10  # small (4 KiB a shard) goes resident; big must stream
    groups = tsh.build_sharded_groups(mesh, files, budget_bytes=budget)
    assert len(groups) == 2
    (sdb_small, _), (sdb_big, _) = groups
    assert sdb_small.num_waves == 1 and sdb_small.db is not None
    assert sdb_big.num_waves > 1 and sdb_big.db is None
    # Big group's waves fit the pool the resident group leaves free:
    # per-shard peak = resident + 2 waves <= budget.
    assert _peak_shard_bytes(groups) <= budget
    assert sdb_small.wave_shard_bytes == (1 << 12) * 4

    queries = [(i, rand_seq(n)) for i, n in enumerate((100, 64, 150))]
    jgroups = jax_sharded.build_sharded_groups(jax_make_search_mesh(1, n_shards), files,
                                               budget_bytes=budget)
    for threshold in (1.0, 0.4, 0.1):
        got = tsh.search_sharded_groups(groups, files, queries, threshold)
        want = search_database_files(files, queries, threshold)
        assert _fields(got) == _fields({q: r for q, r in want.items() if r})
        assert threshold > 0.1 or any(got.values())
        assert _triples(got) == _triples(
            jax_sharded.search_sharded_groups(jgroups, files, queries, threshold))
        assert _triples(want) == _triples(jax_host_search(files, queries, threshold))


def test_residency_plan_holds_the_budget(tmp_path):
    """Two chunks of 0.6 x budget a shard each: together they pass the
    budget, so neither may sit resident beside the other's waves (the JAX
    plan hands each the whole budget and both go resident, 1.2 x budget).
    One rule for all: resident + two transient waves <= budget a shard."""
    from kwage_tpu_torch.core.params import BloomParam as PortParam
    from kwage_tpu_torch.search.engine import search_database_files

    lrng = np.random.default_rng(7)
    # Two params, so two groups; 96 words x 2^10 rows x 4 B = 384 KiB a file.
    files = [
        _mk_db(tmp_path / "a.db", lrng, PortParam(31, 10, 3, 0), 96 * 32, 0),
        _mk_db(tmp_path / "b.db", lrng, PortParam(31, 10, 2, 0), 96 * 32, 5000),
    ]
    n_shards = 4
    shard_bytes = 96 // n_shards * (1 << 10) * 4
    budget = shard_bytes * 10 // 6
    mesh = port_mesh(2, n_shards)
    groups = tsh.build_sharded_groups(mesh, files, budget_bytes=budget)
    assert [sdb.db is None for sdb, _ in groups] == [True, True]
    assert _peak_shard_bytes(groups) <= budget
    jgroups = jax_sharded.build_sharded_groups(jax_make_search_mesh(2, n_shards), files,
                                               budget_bytes=budget)
    assert all(j.db is not None for j, _ in jgroups)   # the fault the port does not copy
    queries = [(i, rand_seq(n)) for i, n in enumerate((60, 45))]
    for threshold in (1.0, 0.5):
        got = tsh.search_sharded_groups(groups, files, queries, threshold)
        want = search_database_files(files, queries, threshold)
        assert _fields(got) == _fields({q: r for q, r in want.items() if r})
    # All of it fits a doubled budget: everything resident.
    fit = tsh.build_sharded_groups(mesh, files, budget_bytes=2 * shard_bytes)
    assert all(sdb.db is not None for sdb, _ in fit)


def test_over_budget_corpus_keeps_chunks_resident(tmp_path, monkeypatch):
    """Four files of one shape, a budget of two and a half: with the waves'
    share at half a file (what SLAB_RESERVE_BYTES is to a corpus of real
    size) the files are cut into chunks of two, the first goes resident
    and the second streams in waves of a quarter file, the peak within the
    budget; the hit lists equal the host engine's. (The full route:
    GATHER_SHARE 0.)"""
    from kwage_tpu_torch.core.params import BloomParam as PortParam
    from kwage_tpu_torch.search.engine import search_database_files

    monkeypatch.setattr(ts, "GATHER_SHARE", 0.0)
    lrng = np.random.default_rng(9)
    param = PortParam(31, 10, 3, 0)
    files = [_mk_db(tmp_path / f"f{i}.db", lrng, param, 64 * 32, 3000 * i) for i in range(4)]
    n_shards = 4
    shard_bytes = 64 // n_shards * (1 << 10) * 4      # one file's share of a shard
    monkeypatch.setattr(ts, "SLAB_RESERVE_BYTES", shard_bytes // 2)
    budget = shard_bytes * 5 // 2
    groups = tsh.build_sharded_groups(port_mesh(1, n_shards), files, budget_bytes=budget)
    assert [(sdb.db is not None, idxs) for sdb, idxs in groups] == [(True, [0, 1]), (False, [2, 3])]
    assert groups[1][0].wave_shard_bytes == shard_bytes // 4 and groups[1][0].num_waves == 8
    assert _peak_shard_bytes(groups) == budget
    queries = [(i, rand_seq(n)) for i, n in enumerate((60, 45, 120))]
    for threshold in (1.0, 0.5):
        got = tsh.search_sharded_groups(groups, files, queries, threshold)
        want = search_database_files(files, queries, threshold)
        assert _fields(got) == _fields({q: r for q, r in want.items() if r})


@pytest.fixture(scope="module")
def golden_dbs(tmp_path_factory, data_dir, golden_dir):
    """Five golden accessions through the port's Maestro: .db files."""
    from kwage_tpu_torch.core import FilterInfo, str_to_accession
    from kwage_tpu_torch.io.inventory import write_inventory
    from kwage_tpu_torch.parallel.maestro import LocalFastaResolver, Maestro, MaestroOptions

    work = tmp_path_factory.mktemp("sharded_golden")
    with open(golden_dir / "e2e" / "manifest.json") as f:
        man = json.load(f)
    write_inventory(str(work / "inv.bin"),
                    [FilterInfo(run_accession=str_to_accession(a))
                     for a in man["accessions"][:5]])
    opt = MaestroOptions(
        metadata_file=str(work / "inv.bin"),
        scratch_bloom_dir=str(work / "bloom"),
        scratch_database_dir=str(work / "db"),
        status_file=str(work / "status.bin"),
        kmer_len=man["k"], min_kmer_count=man["min_kmer_count"],
        false_positive_probability=man["fp"],
        min_log_2_filter_len=man["minL"], max_log_2_filter_len=man["maxL"],
        min_log_2_count_len=man["minLc"], max_log_2_count_len=man["maxLc"],
    )
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    return sorted(os.path.join(work, "db", f) for f in os.listdir(work / "db")
                  if f.endswith(".db"))


@pytest.fixture(scope="module")
def golden_queries(data_dir):
    from kwage_tpu_torch.io.sequence import iter_sequences

    return [(i, s) for i, (_, s) in
            enumerate(iter_sequences(str(data_dir / "queries.fasta")))][:3]


def test_resident_sharded_groups_reusable(golden_dbs, golden_queries):
    """build_sharded_groups once, search many times (the mesh serving
    primitive): results identical to the one-shot sharded_search_files, to
    the host engine and to the JAX mesh."""
    from kwage_tpu_torch.search.engine import search_database_files

    mesh = port_mesh(2, 4)
    jmesh = jax_make_search_mesh(2, 4)
    groups = tsh.build_sharded_groups(mesh, golden_dbs, budget_bytes=1 << 10)
    # 1 KiB holds no word column: every group streams (one column a shard).
    assert all(sdb.db is None for sdb, _ in groups)
    for threshold in (1.0, 0.5):
        got = tsh.search_sharded_groups(groups, golden_dbs, golden_queries, threshold)
        want = tsh.sharded_search_files(mesh, golden_dbs, golden_queries, threshold,
                                        budget_bytes=1 << 10)
        assert _fields(got) == _fields(want)
        host = search_database_files(golden_dbs, golden_queries, threshold)
        assert _fields(got) == _fields({q: r for q, r in host.items() if r})
        assert _triples(got) == _triples(jax_sharded.sharded_search_files(
            jmesh, golden_dbs, golden_queries, threshold, budget_bytes=1 << 10))
        assert any(got.values())


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_mesh_resident_searcher_renders_the_same_bytes(golden_dbs, golden_queries, fmt):
    """MeshResidentSearcher over the 8-way mesh == ResidentSearcher == the
    host searcher, resident and under a budget that streams."""
    from kwage_tpu_torch.search.resident import (
        HostResidentSearcher,
        MeshResidentSearcher,
        ResidentSearcher,
    )

    seqs = [s for _, s in golden_queries]
    single = ResidentSearcher(golden_dbs, CPU)
    host = HostResidentSearcher(golden_dbs)
    for budget in (None, 1 << 10):
        mesh = MeshResidentSearcher(golden_dbs, port_mesh(1, 8), budget_bytes=budget)
        for threshold in (1.0, 0.5):
            out = mesh.render(seqs, threshold, fmt)
            assert out == single.render(seqs, threshold, fmt)
            assert out == host.render(seqs, threshold, fmt)
            assert "SRR" in out or "ERR" in out or "DRR" in out


def test_search_server_takes_the_mesh_with_several_devices(golden_dbs, monkeypatch):
    from kwage_tpu_torch.search.resident import (
        MeshResidentSearcher,
        ResidentSearcher,
        SearchServer,
    )

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(tmesh, "default_devices", lambda: [CPU] * 4)
    server = SearchServer(golden_dbs)
    try:
        assert isinstance(server.searcher, MeshResidentSearcher)
        assert server.searcher.mesh.shape == {"data": 1, "filters": 4}
    finally:
        server._server.server_close()
    monkeypatch.undo()
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    server = SearchServer(golden_dbs)
    try:
        assert isinstance(server.searcher, ResidentSearcher)
    finally:
        server._server.server_close()


def test_from_files_never_joins_the_files_on_the_host(tmp_path):
    """from_files stages each file's columns from its mmap: the host
    allocates less than one file beside them, resident or streaming (the
    JAX class reads every file and hstacks them: twice the corpus)."""
    from kwage_tpu_torch.core.params import BloomParam as PortParam

    lrng = np.random.default_rng(8)
    param = PortParam(31, 13, 3, 0)
    files = [_mk_db(tmp_path / f"f{i}.db", lrng, param, 2048, 3000 * i) for i in range(4)]
    file_bytes = (1 << 13) * 256
    mesh = port_mesh(1, 4)
    for budget in (None, file_bytes // 4):
        tracemalloc.start()
        sdb = tsh.ShardedDatabase.from_files(mesh, files, budget)
        counts, _ = sdb.search_counts([rand_seq(80)])
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert (sdb.db is None) == (budget is not None)
        assert counts.shape == (1, 4 * 2048)
        assert peak < file_bytes, (budget, peak)
    assert sdb.num_waves > 2
    assert [hi - lo for lo, hi, _ in sdb.file_spans] == [64] * 4


def test_dryrun_multichip_on_logical_shards(monkeypatch, capsys):
    from kwage_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    dryrun_multichip(8)
    assert "8-slot mesh is made of logical shards" in capsys.readouterr().out


@pytest.mark.parametrize("W,t", [(3, 1), (33, 2), (64, 7)])
def test_total_hits_ref_counts_columns(W, t):
    """total_hits_ref against a count in numpy, with thresholds on both
    sides of the counts and a width that is no multiple of 32."""
    lrng = np.random.default_rng(W)
    R, nq, nk, nh = 128, 4, 40, 2
    db = lrng.integers(0, 1 << 32, size=(R, W), dtype=np.uint32)
    idx = lrng.integers(0, R, size=(nq, nk, nh), dtype=np.int32)
    valid = lrng.random((nq, nk)) < 0.8
    valid[1] = False
    tcount = np.array([t, 1, t + 3, nk], dtype=np.int32)
    args = (ts.words_to_tensor(db, CPU), torch.from_numpy(idx), torch.from_numpy(valid))
    counts = ts.counts_ref(*args).numpy()
    want = (counts >= tcount[:, None]).sum(axis=1)
    got = ts.search_total_hits(*args, torch.from_numpy(tcount))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and want[1] == 0 and want[0] > 0
    with pytest.raises(ValueError):
        ts.search_total_hits(*args, torch.zeros(nq, dtype=torch.int32))


@pytest.mark.cuda
def test_total_hits_kernel_matches_ref(cuda_device):
    for R, W, nq, nk, nh in ((256, 3, 4, 45, 5), (1 << 16, 100, 5, 300, 3), (1 << 12, 33, 9, 64, 2)):
        lrng = np.random.default_rng(R + W)
        db = lrng.integers(0, 1 << 32, size=(R, W), dtype=np.uint32)
        idx = lrng.integers(0, R, size=(nq, nk, nh), dtype=np.int32)
        valid = lrng.random((nq, nk)) < 0.9
        tcount = lrng.integers(1, nk // 4, size=nq).astype(np.int32)
        args = (ts.words_to_tensor(db, cuda_device), torch.from_numpy(idx).to(cuda_device),
                torch.from_numpy(valid).to(cuda_device), torch.from_numpy(tcount).to(cuda_device))
        assert torch.equal(ts.search_total_hits(*args), ts.total_hits_ref(*args))


@pytest.mark.cuda
def test_mesh_on_logical_shards_of_the_card(cuda_device, corpus):
    param, slices, num_filter = corpus
    mesh = tmesh.make_search_mesh(2, 2, [cuda_device] * 4)
    waved = tsh.ShardedDatabase(mesh, param, slices, num_filter, budget_bytes=8192)
    cpu = tsh.ShardedDatabase(port_mesh(2, 2), param, slices, num_filter)
    queries = [rand_seq(100), rand_seq(200), rand_seq(64)]
    np.testing.assert_array_equal(waved.search_counts(queries)[0], cpu.search_counts(queries)[0])
    np.testing.assert_array_equal(waved.total_hits(queries, 0.3), cpu.total_hits(queries, 0.3))


@pytest.mark.parametrize("kind", ["single", "mesh", "mesh_streamed", "server", "server_mesh"])
def test_searchers_are_freed_on_del(golden_dbs, golden_queries, kind, monkeypatch):
    """With the cyclic collector off, dropping a searcher (or a server that
    served a request) frees it and every ShardedDatabase at once: nothing
    of them sits in a reference cycle, which would keep a card's matrices
    allocated until the next collection."""
    import gc
    import weakref

    from kwage_tpu_torch.search.resident import (
        MeshResidentSearcher,
        ResidentSearcher,
        SearchServer,
    )

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    if kind == "server_mesh":
        monkeypatch.setattr(tmesh, "default_devices", lambda: [CPU] * 4)
    seqs = [s for _, s in golden_queries]
    gc.collect()
    gc.disable()
    try:
        server = None
        if kind == "single":
            searcher = ResidentSearcher(golden_dbs, CPU)
        elif kind.startswith("mesh"):
            searcher = MeshResidentSearcher(golden_dbs, port_mesh(1, 8),
                                            budget_bytes=1 << 10 if kind == "mesh_streamed"
                                            else None)
        else:
            threads = threading.active_count()
            server = SearchServer(golden_dbs)
            server.start()
            with socket.create_connection(server.address) as conn, conn.makefile("rw") as f:
                f.write(json.dumps({"queries": seqs[:2], "threshold": 0.5}) + "\n")
                f.flush()
                assert json.loads(f.readline())["ok"]
            searcher = server.searcher
        assert searcher.render(seqs, 1.0, "csv")
        refs = [weakref.ref(searcher)] + [weakref.ref(sdb) for sdb, _ in
                                          getattr(searcher, "groups", [])]
        assert isinstance(searcher, MeshResidentSearcher) == (kind in (
            "mesh", "mesh_streamed", "server_mesh"))
        if server is not None:
            server.shutdown()
            # The connection's handler thread ends once it reads the close.
            for _ in range(1000):
                if threading.active_count() <= threads:
                    break
                time.sleep(0.01)
        del searcher, server
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
