"""The port's scale programs (kwage_tpu_torch.scale) and chip_smoke.py's
phase 14 on the CPU, at tiny sizes, held to kwage_tpu: the corpus is the
JAX tools' own bytes, the quota table is kwage_tpu's, the at-scale run's
.db files and hit lists equal kwage_tpu's maestro and host engine on the
same corpus, the soak's rounds equal kwage_tpu's host build and engine,
an L=26 file searches alike in both packages, and the device search
refuses an L=32 file before it reads it."""

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import textwrap
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kwage_tpu.cli.kwage import main as jax_kwage_main
from kwage_tpu.core import FilterInfo as JaxFilterInfo
from kwage_tpu.core import str_to_accession as jax_str_to_accession
from kwage_tpu.core.params import filters_per_file_quota as jax_quota
from kwage_tpu.io.bloom_file import write_bloom_file as jax_write_bloom_file
from kwage_tpu.io.inventory import write_inventory as jax_write_inventory
from kwage_tpu.ops import search as jax_search
from kwage_tpu.parallel.maestro import LocalFastaResolver as JaxResolver
from kwage_tpu.parallel.maestro import Maestro as JaxMaestro
from kwage_tpu.parallel.maestro import MaestroOptions as JaxMaestroOptions
from kwage_tpu.pipeline import BuildOptions as JaxBuildOptions
from kwage_tpu.pipeline import build_bloom_from_file as jax_build_bloom_from_file
from kwage_tpu.pipeline import build_db_from_bloom_files as jax_build_db
from kwage_tpu.pipeline.merge_db import merge_databases as jax_merge_databases

import chip_smoke
from kwage_tpu_torch.cli.kwage import main as torch_kwage_main
from kwage_tpu_torch.core import FilterInfo, str_to_accession
from kwage_tpu_torch.core.params import BloomParam, filters_per_file_quota
from kwage_tpu_torch.io.bloom_file import BloomFilterRecord, read_bloom_file, write_bloom_file
from kwage_tpu_torch.io.db_file import DBFileHeader, DBFileReader, write_db_file
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.parallel.mesh import make_search_mesh
from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files
from kwage_tpu_torch.scale import _corpus, at_scale, prod_l, soak
from kwage_tpu_torch.search.resident import MeshResidentSearcher, ResidentSearcher

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _sha(path) -> str:
    return hashlib.sha256(_read(path)).hexdigest()


# --- the corpus ---------------------------------------------------------------------

def jax_tool_corpus(tool: str, work: str, n_acc: int, genome: int, cov: int, halt: int):
    """The generation block of a JAX tool's main() (from ``rng =`` to the
    inventory's path), run as written: (query_seqs, infos)."""
    src = (REPO / "tools" / tool).read_text()
    start = src.index("        rng = np.random.default_rng(")
    end = src.index('        inv = os.path.join(work, "inv.bin")')
    ns = dict(np=np, os=os, work=work, N_ACC=n_acc, GENOME=genome, COV=cov, HALT=halt,
              READ_LEN=160, FilterInfo=JaxFilterInfo, str_to_accession=jax_str_to_accession)
    exec(textwrap.dedent(src[start:end]), ns)
    return ns["query_seqs"], ns["infos"]


# (tool, seed, prefix, the tool's query indices for n_acc and halt)
TOOLS = [
    ("run_at_scale.py", 0, "SRR9", lambda n, h: (5, 2500, 4150, n - 5)),
    ("run_at_scale_prodL.py", 1, "SRR8", lambda n, h: (7, 1024, h + 10, n - 3)),
]


@pytest.mark.parametrize("tool,seed,prefix,query_at", TOOLS, ids=[t[0] for t in TOOLS])
@pytest.mark.parametrize("n_acc,genome,cov,halt", [(9, 1500, 4, 1), (14, 2200, 3, 3)])
def test_corpus_is_the_jax_tools(tmp_path, tool, seed, prefix, query_at, n_acc, genome, cov,
                                 halt):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    want_queries, infos = jax_tool_corpus(tool, str(jax_dir), n_acc, genome, cov, halt)
    jax_write_inventory(str(jax_dir / "inv.bin"), infos)
    got = _corpus.generate(str(port_dir), n_acc, genome, cov, seed, prefix,
                           query_at(n_acc, halt))
    assert got.queries == want_queries and len(want_queries) >= 1
    assert got.accessions == [f"{prefix}{i:06d}" for i in range(n_acc)]
    names = sorted(os.listdir(jax_dir / "fa"))
    assert names == sorted(os.listdir(got.src)) and len(names) == n_acc
    for name in names:
        assert _read(jax_dir / "fa" / name) == _read(os.path.join(got.src, name)), name
    assert _read(jax_dir / "inv.bin") == _read(got.inv)
    assert got.bp_per_acc == genome * cov // 160 * 160


def test_fasta_reads_are_the_corpus_reads(tmp_path):
    corpus = _corpus.generate(str(tmp_path), 2, 1200, 4, 0, "SRR9", ())
    reads = _corpus.fasta_reads(os.path.join(corpus.src, "SRR9000001.fasta"))
    assert reads.shape == (1200 * 4 // 160, 160)
    text = _read(os.path.join(corpus.src, "SRR9000001.fasta")).split(b"\n")
    assert [r.tobytes() for r in reads] == text[1::2][: reads.shape[0]]


@pytest.mark.parametrize("log2_len", range(18, 33))
def test_quota_table_is_kwage_tpus(log2_len):
    assert filters_per_file_quota(log2_len) == jax_quota(log2_len)
    assert _corpus.quota_table(18, 32)[str(log2_len)] == jax_quota(log2_len)


def test_machine_check_names_the_shortfall(tmp_path):
    have = _corpus.require_machine(str(tmp_path), 1, 1)
    assert have["disk_free_bytes"] > 0 and have["ram_available_bytes"] > 0
    with pytest.raises(RuntimeError, match="GiB free on .* needed"):
        _corpus.require_machine(str(tmp_path), 1 << 60, 1)
    with pytest.raises(RuntimeError, match="host memory available"):
        _corpus.require_machine(str(tmp_path), 1, 1 << 60)


def test_phase_log_prints_a_line_a_phase(capsys, tmp_path):
    log = _corpus.PhaseLog(CPU)
    rec = log.log("generate", accessions=3)
    assert rec["phase"] == "generate" and rec["peak_rss_mb"] > 0
    assert rec["peak_device_bytes"] is None
    log.save(str(tmp_path / "out.json"))
    assert '"phase": "generate"' in capsys.readouterr().out
    assert (tmp_path / "out.json").read_text().startswith("[")


# --- at_scale ----------------------------------------------------------------------

def jax_maestro(corpus_dir: pathlib.Path, inv: str, src: str, halt: int, **kw) -> list[str]:
    """kwage_tpu's maestro, run A (halted) and run B, into ``corpus_dir``;
    returns the .db names."""
    for limit in (halt, 0):
        opt = JaxMaestroOptions(
            metadata_file=inv, scratch_bloom_dir=str(corpus_dir / "bloom"),
            scratch_database_dir=str(corpus_dir / "db"),
            status_file=str(corpus_dir / "status.bin"), min_kmer_count=2, kmer_len=31,
            num_workers=2, lazy_inventory=True, limit_num_download=limit, **kw)
        m = JaxMaestro(opt, JaxResolver(src))
        m.restore()
        m.run()
    return sorted(os.listdir(corpus_dir / "db"))


def test_at_scale_equals_kwage_tpu(tmp_path, monkeypatch):
    for name, value in (("N_ACC", 12), ("HALT", 8), ("GENOME", 3000), ("DEVICE_N", 4),
                        ("REQUIRE_FULL", 0)):
        monkeypatch.setattr(at_scale, name, value)
    work = tmp_path / "work"
    assert at_scale.main([str(work)]) == 0
    # kwage_tpu's maestro over the port's corpus writes the same .db files.
    names = jax_maestro(tmp_path / "jax", str(work / "inv.bin"), str(work / "fa"), 8)
    assert names == sorted(os.listdir(work / "db")) and len(names) == 2
    for name in names:
        assert _read(tmp_path / "jax" / "db" / name) == _read(work / "db" / name), name
    # kwage_tpu's host engine over the merged corpus: the port's bytes.
    out = tmp_path / "jax.out"
    assert jax_kwage_main(["-d", str(work / "corpus"), "-t", "0.8", "-i",
                           str(work / "queries.fasta"), "-o", str(out)]) == 0
    assert _read(out) == _read(work / "host.out") == _read(work / "device.out")
    assert b'"run"' in _read(out)
    lines = (work / "at_scale.json").read_text()
    for phase in ("generate", "maestro_run_A", "maestro_run_B_restart",
                  "maestro_device_build_cold", "maestro_device_build_warm", "shape_check",
                  "merge_partials", "search_host", "search_device", "search_device_resident"):
        assert f'"phase": "{phase}"' in lines, phase
    assert '"oracle": "absent"' in lines or '"byte_identical_to_oracle": true' in lines


def test_at_scale_fails_when_a_device_output_differs(tmp_path, monkeypatch):
    """A device search that returns other bytes fails the run (exit 1)."""
    for name, value in (("N_ACC", 12), ("HALT", 8), ("GENOME", 3000), ("DEVICE_N", 2),
                        ("REQUIRE_FULL", 0)):
        monkeypatch.setattr(at_scale, name, value)
    real = ResidentSearcher.render
    monkeypatch.setattr(ResidentSearcher, "render",
                        lambda self, *a, **k: real(self, *a, **k) + " ")
    assert at_scale.main([str(tmp_path / "work")]) == 1


def test_at_scale_raises_without_a_card(monkeypatch):
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        at_scale.main([])


# --- prod_l -----------------------------------------------------------------------

def test_prod_l_at_a_small_length(tmp_path, monkeypatch):
    """The production-L program's phases at L=16 (the filter length pinned
    as at 26), then --device-only over its kept workdir."""
    for name, value in (("N_ACC", 40), ("HALT", 36), ("GENOME", 3000), ("LPROD", 16),
                        ("DEVICE_N", 4), ("REQUIRE_FULL", 0)):
        monkeypatch.setattr(prod_l, name, value)
    work = tmp_path / "work"
    assert prod_l.main([str(work)]) == 0
    lines = (work / "prod_l.json").read_text()
    for phase in ("quota_check", "maestro_run_A", "maestro_run_B_restart", "shape_check",
                  "merge_partials", "search_host", "search_device", "sharded_wave_search",
                  "sharded_wave_search_budget", "maestro_device_build_cold",
                  "maestro_device_build_warm"):
        assert f'"phase": "{phase}"' in lines, phase
    assert _read(work / "host.out") == _read(work / "device.out")
    assert prod_l.main(["--device-only", str(work)]) == 0
    assert '"phase": "search_host_rerun"' in (work / "prod_l_device.json").read_text()
    # The same corpus through kwage_tpu's maestro (the filter length
    # pinned) and merge_db: the port's merged file, byte for byte.
    jax_names = jax_maestro(tmp_path / "jax", str(work / "inv.bin"), str(work / "fa"), 36,
                            min_log_2_filter_len=16, max_log_2_filter_len=16)
    jax_paths = [str(tmp_path / "jax" / "db" / n) for n in jax_names]
    jax_merge_databases(jax_paths, verbose=False)
    left = [p for p in jax_paths if os.path.exists(p)]
    assert len(left) == 1 and os.listdir(work / "db") == [os.path.basename(left[0])]
    assert _read(left[0]) == _read(work / "db" / os.path.basename(left[0]))


def test_wave_plan_streams_under_half_the_widest_file(tmp_path, monkeypatch):
    for name, value in (("N_ACC", 40), ("HALT", 36), ("GENOME", 3000), ("LPROD", 16),
                        ("DEVICE_N", 2), ("REQUIRE_FULL", 0)):
        monkeypatch.setattr(prod_l, name, value)
    work = tmp_path / "work"
    assert prod_l.main([str(work)]) == 0
    recs = {r["phase"]: r for r in json.loads((work / "prod_l.json").read_text())}
    whole, halved = recs["sharded_wave_search"], recs["sharded_wave_search_budget"]
    assert whole["n_waves"] == 1 and not whole["forced_by_memory_pressure"]
    assert halved["n_waves"] >= 2 and halved["forced_by_memory_pressure"]
    assert whole["hit_lists_equal_host"] and halved["hit_lists_equal_host"]
    assert halved["budget_bytes_a_shard"] * 2 == sum(halved["bytes_per_wave"])


def test_prod_l_refuses_a_small_machine(tmp_path, monkeypatch):
    monkeypatch.setattr(prod_l, "N_ACC", 1 << 40)
    with pytest.raises(RuntimeError, match="machine too small"):
        prod_l.main([str(tmp_path / "work")])


def test_device_only_needs_a_kept_workdir(tmp_path):
    with pytest.raises(SystemExit, match="run prod_l there first"):
        prod_l.main(["--device-only", str(tmp_path)])


# --- soak --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1001, 1003, 1004])
def test_soak_round_equals_kwage_tpu(tmp_path, seed):
    """A round passes on the CPU; kwage_tpu's host build and pack over
    the round's FASTA files give the same .db bytes, and its host engine
    the same output."""
    work = tmp_path / "port"
    work.mkdir()
    res = soak.run_round(seed, str(work))
    assert res["failures"] == [] and res["args"] is not None
    opts = JaxBuildOptions(**dataclasses.asdict(res["opts"]))
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    groups = {}
    for fa in sorted(work.glob("*.fasta")):
        if fa.name == "q.fasta":
            continue
        acc = fa.stem
        try:
            rec = jax_build_bloom_from_file(
                str(fa), opts, JaxFilterInfo(run_accession=jax_str_to_accession(acc)))
        except Exception:  # noqa: BLE001 -- the JAX tool skips such an accession
            assert not (work / f"{acc}.bloom").exists()
            continue
        path = jax_dir / f"{acc}.bloom"
        jax_write_bloom_file(str(path), rec)
        assert _read(path) == _read(work / f"{acc}.bloom"), acc
        groups.setdefault(rec.param, []).append(str(path))
    args = list(res["args"])
    for gi, (param, paths) in enumerate(sorted(groups.items())):
        db = jax_dir / f"sra.{gi}.db"
        jax_build_db(str(db), param, paths)
        assert _read(db) == _read(res["dbs"][gi])
        args[args.index(res["dbs"][gi])] = str(db)
    out = tmp_path / "jax.out"
    assert jax_kwage_main(args + ["-o", str(out)]) == 0
    assert _read(out) == _read(work / "host.out") == _read(work / "device.out")


def test_soak_counts_a_device_mismatch(tmp_path, monkeypatch, capsys):
    """A device search that differs is a failure, and the run exits 1."""
    real = ts.search_files_device

    def off_by_one(paths, queries, threshold, device, profile=None):
        out = real(paths, queries, threshold, device, profile)
        for lst in out.values():
            for m in lst:
                m.num_kmers_found -= 1
        return out

    monkeypatch.setattr(ts, "search_files_device", off_by_one)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    assert soak.main(["2", "1003"]) == 1
    assert "DEVICE mismatch" in capsys.readouterr().out


# --- L=26 in both packages -----------------------------------------------------------

def test_l26_file_searches_alike_in_both_packages(tmp_path):
    """One file of 32 filters at L=26 (W=1, 256 MiB of rows): kwage_tpu's
    search_counts / search_complete (on JAX's CPU) and the port's plain
    versions give the same bytes; the port's --device (plain versions)
    and host engine, and kwage_tpu's host engine, the same output."""
    L, nf, k, nh = 26, 32, 31, 3
    rng = np.random.default_rng(26)
    slices = rng.integers(0, 256, size=(1 << L, 4), dtype=np.uint8)
    for r0 in range(0, 1 << L, 1 << 23):   # ~7/8 of the bits set, in blocks
        for _ in range(2):
            slices[r0:r0 + (1 << 23)] |= rng.integers(0, 256, size=(1 << 23, 4), dtype=np.uint8)
    queries = ["".join(rng.choice(list("ACGT"), size=n)) for n in (400, 200, 120, 60)]
    idx, valid, nk = ts.make_query_batch(queries, k, nh, L)
    slices[idx[0][valid[0]].reshape(-1)] = 0xFF      # query 0: every filter, completely
    path = tmp_path / "l26.db"
    hdr = DBFileHeader(kmer_len=k, num_hash=nh, log_2_filter_len=L, num_filter=nf)
    write_db_file(str(path), hdr, slices,
                  [FilterInfo(run_accession=str_to_accession(f"SRR{100 + i}"))
                   for i in range(nf)])
    words = ts.db_bytes_to_words(slices)
    del slices
    jidx, jvalid, _ = jax_search.make_query_batch(queries, k, nh, L)
    assert np.array_equal(jidx, idx) and np.array_equal(jvalid, valid)
    jdb = jnp.asarray(words)
    db = ts.words_to_tensor(words, CPU)
    del words
    idx_t, valid_t = torch.from_numpy(idx), torch.from_numpy(valid)
    want = np.asarray(jax_search.search_complete(jdb, jnp.asarray(idx), jnp.asarray(valid)))
    got = ts.tensor_to_words(ts.search_complete(db, idx_t, valid_t))
    assert got.tobytes() == want.tobytes() and got[0, 0] == 0xFFFFFFFF
    want = np.asarray(jax_search.search_counts(jdb, jnp.asarray(idx), jnp.asarray(valid)))
    got = ts.search_counts(db, idx_t, valid_t).numpy()
    assert got.tobytes() == want.tobytes() and 0 < got[1:].max() < nk[1]
    del jdb, db
    for t in ("1.0", "0.5"):
        outs = []
        for main, extra in ((torch_kwage_main, ["--device"]), (torch_kwage_main, []),
                            (jax_kwage_main, [])):
            out = tmp_path / f"{len(outs)}.out"
            assert main(["-d", str(path), "-t", t, "--o.csv", "-o", str(out)]
                        + extra + queries) == 0
            outs.append(_read(out))
        assert outs[0] == outs[1] == outs[2] and outs[0].count(b"\n") > 1


# --- L=32 on the device path ------------------------------------------------------

@pytest.fixture
def l32_file(tmp_path, monkeypatch):
    """A header-only .db at L=32 (its rows would be 4 GiB); a read of its
    slices fails the test."""
    path = tmp_path / "l32.db"
    path.write_bytes(DBFileHeader(kmer_len=31, num_hash=3, log_2_filter_len=32,
                                  num_filter=1).pack())

    def no_read(self, *a, **k):
        raise AssertionError("the slices were read")

    for name in ("mmap_slices", "read_slices", "read_slice_rows"):
        monkeypatch.setattr(DBFileReader, name, no_read)
    return str(path)


def test_kwage_device_refuses_l32_from_the_header(l32_file, capsys):
    assert torch_kwage_main(["-d", l32_file, "--device", "ACGT" * 20]) == 1
    err = capsys.readouterr().err
    assert "L=32" in err and "host engine" in err


@pytest.mark.parametrize("entry", ["search_files_device", "ResidentSearcher",
                                   "MeshResidentSearcher"])
def test_device_searchers_refuse_l32_before_any_read(l32_file, entry):
    with pytest.raises(ValueError, match=r"L=32.*host engine"):
        if entry == "search_files_device":
            ts.search_files_device([l32_file], [(0, "ACGT" * 20)], 1.0, CPU)
        elif entry == "ResidentSearcher":
            ResidentSearcher([l32_file], CPU)
        else:
            MeshResidentSearcher([l32_file], make_search_mesh(1, 2, [CPU, CPU]))


def test_l31_is_the_device_searchs_limit(tmp_path):
    """Rows at L=31 stay inside int32; at L=32 both packages' query batch
    turns rows past 2^31 negative (kwage_tpu then gathers them unchecked)."""
    q = ["".join(np.random.default_rng(3).choice(list("ACGT"), size=300))]
    for L, wraps in ((31, False), (32, True)):
        idx, valid, _ = ts.make_query_batch(q, 31, 5, L)
        jidx, _, _ = jax_search.make_query_batch(q, 31, 5, L)
        assert np.array_equal(idx, jidx)
        assert bool((idx[valid] < 0).any()) == wraps
    assert ts.MAX_DEVICE_LOG2_LEN == 31


# --- chip_smoke.py's phase 14 helpers -----------------------------------------------

def random_blooms(work: pathlib.Path, n: int, param: BloomParam, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        bits = rng.integers(0, 256, size=param.filter_len // 8, dtype=np.uint8)
        rec = BloomFilterRecord(param=param, crc32=zlib.crc32(bits.tobytes()),
                                info=FilterInfo(run_accession=str_to_accession(f"SRR{500 + i}")),
                                bits=bits)
        paths.append(str(work / f"{i}.bloom"))
        write_bloom_file(paths[-1], rec)
    return paths


@pytest.mark.parametrize("n,copies", [(4, 32), (3, 5)])
def test_repeated_pack_and_host_digest_at_l14(tmp_path, n, copies):
    """The repeated-path pack through the device transpose (plain versions)
    equals the host pack; host_pack_sha256 gives the host pack's sha256
    without writing it, in chunks (here 4 of 2^12 bits), beside the file's
    own, and names a chunk whose bytes differ and a wrong header."""
    param = BloomParam(kmer_len=31, log_2_filter_len=14, num_hash=4)
    repeated = random_blooms(tmp_path, n, param, n) * copies
    dev, host = str(tmp_path / "dev.db"), str(tmp_path / "host.db")
    build_db_from_bloom_files(dev, param, repeated, device=CPU)
    build_db_from_bloom_files(host, param, repeated)
    assert _sha(dev) == _sha(host)
    assert chip_smoke.host_pack_sha256(dev, param, repeated, 1 << 12) == (_sha(host), _sha(dev))
    bad = str(tmp_path / "bad.db")
    shutil.copy(dev, bad)
    with open(bad, "r+b") as f:
        f.seek(44 + (3 << 12) * -(-n * copies // 8) + 5)   # a row of the last chunk
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(RuntimeError, match=r"chunks \[3\] of 4096 bits differ"):
        chip_smoke.host_pack_sha256(bad, param, repeated, 1 << 12)
    shutil.copy(dev, bad)
    with open(bad, "r+b") as f:
        f.seek(12)   # kmer_len
        f.write((30).to_bytes(4, "little"))
    with pytest.raises(RuntimeError, match="header differs"):
        chip_smoke.host_pack_sha256(bad, param, repeated, 1 << 12)


def test_db_tail_is_the_written_tail(tmp_path):
    param = BloomParam(kmer_len=31, log_2_filter_len=14, num_hash=4)
    blooms = random_blooms(tmp_path, 5, param, 1)
    path = str(tmp_path / "x.db")
    hdr = build_db_from_bloom_files(path, param, blooms)
    infos = [read_bloom_file(p, with_bits=False).info for p in blooms]
    assert _read(path)[hdr.info_start:] == chip_smoke.db_tail(infos, hdr.info_start)


def test_phase14_rehearsal_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 14 whole at L=18 (the filter length pinned as at 26), the full
    file 256 filters over a 1 MiB fusion budget (8 slabs), the mesh on 4
    logical shards at 1 MiB a shard (2 waves)."""
    monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", str(1 << 20))
    shape = chip_smoke.run_prod_l(str(tmp_path), CPU, 0, log2_len=18, n_acc=8, copies=32,
                                  genome_bp=3000, resident_budget=16 << 20,
                                  mesh_budget=1 << 20)
    assert shape["log2_len"] == 18 and shape["num_acc"] == 8 and shape["selected"] > 0
    out = capsys.readouterr().out
    for line in ("phase 14 build", "phase 14 pack", "phase 14 search", "phase 14 serve"):
        assert line in out, line
    assert "in 8 slabs" in out and "2 waves" in out
