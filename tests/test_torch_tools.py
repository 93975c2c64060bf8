"""The port's counterparts of the JAX package's last device-reaching
programs (kwage_tpu_torch.bench.{search_phases,sorted_gather,ingest,
build_phases,sriracha_model,scaling} and kwage_tpu_torch.scale.dry_sched)
on the CPU, at small sizes, held to kwage_tpu: the two gather phases'
plain versions equal the JAX tool's phase functions, the ingest chain's
images equal kwage_tpu's count_kmers_device_multi + set_filter_bits_multi,
the SriRachA model's inputs and matches equal the JAX tool's and
kwage_tpu's device search; build_phases' .bloom files equal the exact
ground truth, the dry scheduler opens no .bloom, and the mesh of 2 logical
CPU slots counts as one slot does. No test bounds a time. The distributed
proof is in tests/test_torch_dscale.py."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kwage_tpu.ops import search as jax_search
from kwage_tpu.ops.counting import count_kmers_device_multi, set_filter_bits_multi
from kwage_tpu.sriracha import device as jax_sriracha
from kwage_tpu.sriracha.engine import SrirachaOptions as JaxSrirachaOptions
from kwage_tpu.sriracha.engine import canonical_kmers as jax_canonical_kmers
from kwage_tpu_torch.bench import _common, build_phases, ingest, scaling, search_phases
from kwage_tpu_torch.bench import sorted_gather, sriracha_model
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.parallel.mesh import make_search_mesh
from kwage_tpu_torch.parallel.sharded_search import MeshMatrix, sharded_search_counts, to_host
from kwage_tpu_torch.scale import dry_sched

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The plain versions on the CPU, on one thread: the programs time many
    small calls, which threads of several test processes at once slow to a
    crawl."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _few_samples(monkeypatch, module, **more):
    """A program's timing loops cut to one sample of one pass (the figures
    of a CPU run are no device's; the tests read their shape only)."""
    for name, value in {"SAMPLES": 1, "REPLAYS": 1, "RING": 2, **more}.items():
        if hasattr(module, name):
            monkeypatch.setattr(module, name, value)


def _search_inputs(rng, R, W, nq, nk, nh, frac):
    db = rng.integers(0, 1 << 32, size=(R, W), dtype=np.uint32)
    idx = rng.integers(0, R, size=(nq, nk, nh), dtype=np.int32)
    valid = rng.random((nq, nk)) < frac
    return db, idx, valid


def _torch(db, idx, valid):
    return (ts.words_to_tensor(db, CPU), torch.from_numpy(idx), torch.from_numpy(valid))


def _u32(t: torch.Tensor) -> int:
    return int(t.numpy().view(np.uint32)[0])


# --- search_phases: the two gather phases ----------------------------------------------

SHAPES = [(64, 16, 2, 40, 5, 1.0), (128, 131, 3, 77, 3, 1.0), (32, 4, 1, 33, 1, 1.0),
          (256, 64, 4, 128, 5, 1.0)]


@pytest.mark.parametrize("R,W,nq,nk,nh,frac", SHAPES)
def test_gather1_plain_equals_the_jax_phase(R, W, nq, nk, nh, frac):
    """gather1_ref == the JAX tool's p_gather1 (tools/bench_search_phases.py:104):
    seed 0's rows gathered, XOR-reduced over both axes."""
    db, idx, valid = _search_inputs(np.random.default_rng(R + W), R, W, nq, nk, nh, frac)
    km = jnp.asarray(db)[jnp.asarray(idx)[:, :, 0].reshape(-1)]
    want = int(jax.lax.reduce(km, jnp.uint32(0), jax.lax.bitwise_xor, (0, 1)))
    assert _u32(search_phases.gather1_ref(*_torch(db, idx, valid))) == want


@pytest.mark.parametrize("R,W,nq,nk,nh,frac", SHAPES + [(64, 16, 2, 40, 5, 0.4),
                                                         (128, 8, 3, 64, 7, 0.0)])
def test_gather5_and_plain_equals_the_jax_phase(R, W, nq, nk, nh, frac):
    """gather5_and_ref == p_gather5 (:109): kwage_tpu's
    _gather_and_reduce_seeds (kwage_tpu/ops/search.py:71), invalid k-mers
    zeroed, XOR-reduced; padding k-mers included."""
    db, idx, valid = _search_inputs(np.random.default_rng(R * nh), R, W, nq, nk, nh, frac)
    km = jax_search._gather_and_reduce_seeds(jnp.asarray(db), jnp.asarray(idx),
                                             jnp.asarray(valid))
    want = int(jax.lax.reduce(km, jnp.uint32(0), jax.lax.bitwise_xor, (0, 1, 2)))
    assert _u32(search_phases.gather5_and_ref(*_torch(db, idx, valid))) == want


@pytest.mark.parametrize("n", [0, 1, 2, 7, 64, 1001])
def test_xor_fold_is_the_xor_of_every_element(n):
    x = np.random.default_rng(n).integers(-2**31, 2**31, size=n, dtype=np.int32)
    want = int(np.bitwise_xor.reduce(x)) if n else 0
    assert search_phases.xor_fold(torch.from_numpy(x)).tolist() == [want]


def test_gather_wrappers_take_the_plain_versions_on_the_cpu():
    db, idx, valid = _torch(*_search_inputs(np.random.default_rng(3), 64, 16, 2, 40, 5, 0.5))
    before = search_phases.launch_counts()
    assert torch.equal(search_phases.gather1(db, idx, valid),
                       search_phases.gather1_ref(db, idx, valid))
    assert torch.equal(search_phases.gather5_and(db, idx, valid),
                       search_phases.gather5_and_ref(db, idx, valid))
    assert search_phases.launch_counts() == before == {"gather1": 0, "gather5_and": 0}


def test_search_phases_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    for name, value in (("LOG2_L", 10), ("NQ", 2), ("NK", 64)):
        monkeypatch.setattr(search_phases, name, value)
    _few_samples(monkeypatch, search_phases)
    out = tmp_path / "sp.json"
    assert search_phases.main(["--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(last["phases"]) == ["gather1", "gather5_and", "complete", "counts"]
    assert set(last["attribution_ms"]) == {"gather_per_seed", "five_seeds_expected",
                                           "five_seeds_actual", "seed_and_overhead",
                                           "kmer_tree_and", "csa_popcount"}
    assert last["gather1_above_hbm_rate"] is False and "CPU" in last["card"]
    assert json.loads(out.read_text())[-1] == last


# --- sorted_gather ------------------------------------------------------------------------

def test_sorted_gather_orders_are_the_jax_tools():
    """tools/exp_sorted_gather.py's variants: one default_rng(1) multiset in
    three orders."""
    base = np.random.default_rng(1).integers(0, 1 << 18, size=1 << 16, dtype=np.int32)
    got = sorted_gather.orders(18, 1 << 16)
    np.testing.assert_array_equal(got["random"], base)
    np.testing.assert_array_equal(got["sorted"], np.sort(base))
    np.testing.assert_array_equal(got["blocked1024"],
                                  np.concatenate([np.sort(c) for c in base.reshape(-1, 1024)]))


def test_sorted_gather_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(sorted_gather, "LOG2_L", 10)
    monkeypatch.setattr(sorted_gather, "N", 2048)
    _few_samples(monkeypatch, sorted_gather)
    _few_samples(monkeypatch, search_phases)
    assert sorted_gather.main(["--out", str(tmp_path / "sg.json")]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last["gbps"]) == {"random", "sorted", "blocked1024"}
    assert last["sorted_vs_random"] > 0 and last["platform"] == "cpu"


# --- ingest --------------------------------------------------------------------------------

@pytest.mark.parametrize("min_count,unique", [(2, False), (1, True), (3, False)])
def test_ingest_chain_equals_kwage_tpu(min_count, unique):
    """The chain's images and per-accession counts equal kwage_tpu's
    count_kmers_device_multi (kwage_tpu/ops/counting.py:165) +
    set_filter_bits_multi (:257) on JAX-CPU over the same reads."""
    accs, reads, rlen, k, nh, log2l = 3, 48, 64, 31, 5, 12
    reads_t = ingest.make_reads(CPU, accs, reads, rlen, 4, unique=unique, seed=min_count)
    acc_ids = ingest.accession_ids(accs, reads, CPU)
    images, nv = ingest.chain(reads_t, acc_ids, ingest.slots(accs, CPU), accs, k, min_count,
                              nh, log2l)
    r = jnp.asarray(reads_t.numpy())
    ids = jnp.asarray(acc_ids.numpy())
    acc_s, hi_s, lo_s, sel, jnv = count_kmers_device_multi(r, ids, k, min_count, accs)
    slot = jnp.arange(accs + 1, dtype=jnp.int32).at[accs].set(-1)
    want = set_filter_bits_multi(acc_s, hi_s, lo_s, sel, slot, k, nh, log2l, accs)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
    np.testing.assert_array_equal(images.numpy().view(np.uint32), np.asarray(want))
    assert int(nv.sum()) > 0


def test_ingest_reads_follow_the_genomes():
    """Coverage reads are windows of one genome an accession; unique reads
    are not."""
    reads = ingest.make_reads(CPU, 2, 16, 40, 4).numpy()
    assert reads.shape == (32, 40) and set(np.unique(reads)) <= set(b"ACGT")
    n0, _ = ingest.host_truth(reads[:16], 31, 2, 5, 12)
    n1, _ = ingest.host_truth(ingest.make_reads(CPU, 2, 16, 40, 4, unique=True).numpy()[:16],
                              31, 2, 5, 12)
    assert n0 > n1 == 0


def test_ingest_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    for name, value in (("ACCS", 2), ("READS", 32), ("RLEN", 64), ("LOG2L", 12),
                        ("N_HI", 2), ("REPEATS", 1)):
        monkeypatch.setattr(ingest, name, value)
    assert ingest.main(["--out", str(tmp_path / "i.json")]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "device_ingest_mbp_per_sec" and last["value"] > 0
    assert last["floor"]["mbp_per_sec"] > 0 and "not a device figure" in last["unit"]


def _small_ingest(monkeypatch, timings):
    """bench.ingest at the CPU test's sizes with its chain's timer replaced
    by ``timings(call, n)`` (call counts every timing from 1)."""
    for name, value in (("ACCS", 2), ("READS", 32), ("RLEN", 64), ("LOG2L", 12)):
        monkeypatch.setattr(ingest, name, value)
    calls = []

    def timed(reads, acc_ids, slot, min_count, n):
        calls.append(n)
        return timings(len(calls), n)

    monkeypatch.setattr(ingest, "time_chain", timed)
    return calls


def test_ingest_fails_when_every_slope_is_impossible(monkeypatch, tmp_path, capsys):
    """Every slope 0 (the chain's time flat in N): each sample is printed as
    not kept, and after TRIES the run exits through BenchFailure naming the
    impossible samples; no result line is printed."""
    calls = _small_ingest(monkeypatch, lambda call, n: 7.0)
    with pytest.raises(_common.BenchFailure) as e:
        ingest.main(["--out", str(tmp_path / "i.json")])
    assert e.value.code != 0
    assert f"{ingest.TRIES} of {ingest.TRIES} slope samples impossible" in str(e.value)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    samples = [x for x in lines if "sample" in x]
    assert len(samples) == ingest.TRIES and not any(x["kept"] for x in samples)
    assert samples[0]["sample"] == "representative" and samples[0]["ms_per_call"] == 0
    assert not any("metric" in x for x in lines)
    assert len(calls) == 1 + 2 * ingest.TRIES


def test_ingest_drops_a_negative_slope(monkeypatch, tmp_path, capsys):
    """One negative slope among good ones (the first N_HI timing reads
    below the N_LO one): it is printed as not kept and taken again; the run
    passes with the median of REPEATS kept slopes and reports 1 dropped."""
    _small_ingest(monkeypatch, lambda call, n: -10.0 if call == 2 else 2.0 * n)
    assert ingest.main(["--out", str(tmp_path / "i.json")]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    samples = [x for x in lines if "sample" in x]
    assert [x["kept"] for x in samples] == [False] + [True] * 2 * ingest.REPEATS
    assert samples[0]["ms_per_call"] < 0
    last = lines[-1]
    assert last["dropped_samples"] == 1 and last["floor"]["dropped_samples"] == 0
    assert last["ms_per_batch"] == last["floor"]["ms_per_batch"] == 2.0
    assert last["value"] == pytest.approx(2 * 32 * 64 / 2e-3 / 1e6)


# --- build_phases ----------------------------------------------------------------------------

def test_build_phases_blooms_equal_ground_truth(monkeypatch, tmp_path, capsys):
    """The batch's .bloom files equal the exact ground truth (main checks it
    and exits 1 otherwise); each step gets a line."""
    for name, value in (("N", 3), ("BP", 12000), ("REPS", 2)):
        monkeypatch.setattr(build_phases, name, value)
    assert build_phases.main(["--out", str(tmp_path / "bp.json")]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    steps = [x["phase"] for x in lines if "phase" in x]
    assert steps == [*build_phases.STEPS, "total"]
    assert lines[-1]["blooms_equal_ground_truth"] and lines[-1]["filters_per_sec_serial"] > 0


def test_build_phases_fails_on_a_wrong_bloom(monkeypatch, tmp_path):
    """A record that differs from the ground truth fails the run."""
    for name, value in (("N", 2), ("BP", 12000), ("REPS", 1)):
        monkeypatch.setattr(build_phases, name, value)
    real = build_phases.write_bloom_file

    def flipped(path, rec):
        rec.bits[0] ^= 1
        real(path, rec)

    monkeypatch.setattr(build_phases, "write_bloom_file", flipped)
    with pytest.raises(SystemExit) as e:
        build_phases.main(["--out", str(tmp_path / "bp.json")])
    assert "ground truth" in str(e.value)


def test_build_phases_corpus_is_the_jax_tools(tmp_path):
    """tools/bench_build_phases.py's FASTA bytes, one default_rng(0)."""
    paths = build_phases.write_corpus(str(tmp_path), 2, 3000)
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for p in paths:
        genome = lut[rng.integers(0, 4, size=3000 // 4, dtype=np.uint8)]
        starts = rng.integers(0, genome.size - 300 + 1, size=3000 // 300)
        want = b"".join(b">r%d\n" % r + genome[st:st + 300].tobytes() + b"\n"
                        for r, st in enumerate(starts))
        assert open(p, "rb").read() == want


# --- sriracha_model ----------------------------------------------------------------------------

def test_sriracha_model_inputs_are_the_jax_tools():
    subjects, reads = sriracha_model.make_inputs(21, 300, 100, 4)
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    target = lut[rng.integers(0, 4, size=8000)].tobytes().decode()
    for s, (name, kmers) in enumerate(subjects):
        assert name == f"subj{s}"
        np.testing.assert_array_equal(
            kmers, np.unique(jax_canonical_kmers(target[s * 1500:s * 1500 + 2000], 21)))
    for i, (seq, ridx, sidx) in enumerate(reads):
        if i % 3 == 0:
            st = int(rng.integers(0, len(target) - 100))
            assert seq == target[st:st + 100]
        else:
            assert seq == lut[rng.integers(0, 4, size=100)].tobytes().decode()
        assert (ridx, sidx) == (i + 1, 0)


def test_sriracha_model_matches_equal_kwage_tpu(monkeypatch, tmp_path, capsys):
    """main's device run (checked against the port's host engine inside)
    and kwage_tpu's search_reads_device find the same matches."""
    monkeypatch.setattr(sriracha_model, "NREADS", 1200)
    from kwage_tpu_torch.bench import sriracha as bench_sriracha

    _few_samples(monkeypatch, bench_sriracha)
    assert sriracha_model.main(["--out", str(tmp_path / "sm.json")]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    e2e = next(x for x in lines if x.get("phase") == "end_to_end")
    subjects, reads = sriracha_model.make_inputs(21, 1200, 100, 4)
    opt = sriracha_model.options()
    res = jax_sriracha.search_reads_device(
        iter(reads), subjects,
        JaxSrirachaOptions(kmer_len=21, kmer_match_threshold=opt.kmer_match_threshold,
                           min_valid_kmer=opt.min_valid_kmer,
                           max_num_match=opt.max_num_match),
        batch_size=512, span_reads=sriracha_model.SPAN)
    assert e2e["matches"] == [len(r) for r in res] and sum(e2e["matches"]) > 0
    last = lines[-1]
    assert set(last["model"]["projected_mbps"]) == {"rtt_0", "rtt_1ms", "rtt_10ms", "rtt_60ms"}
    assert last["matches_equal_host_engine"]


# --- dry_sched -------------------------------------------------------------------------------

def test_dry_scheduler_opens_no_bloom():
    out = dry_sched.run(3000)
    assert out["ok"] and out["bloom_header_opens"] == 0 and out["accessions"] == 3000
    assert out["db_files_packed"] >= 2


def test_dry_scheduler_counts_bloom_opens(monkeypatch):
    """The count is live: a scheduler that reads a .bloom header per pack is
    caught."""
    from kwage_tpu_torch.parallel import maestro as maestro_mod

    def reading(self, db_index, param, members):
        try:
            maestro_mod.read_bloom_file("/nonexistent.bloom", False)
        except OSError:
            pass
        return members, maestro_mod.STATUS_DATABASE_SUCCESS, f"sra.{db_index}.db", 0.0

    monkeypatch.setattr(dry_sched.DryMaestro, "_build_database", reading)
    out = dry_sched.run(600)
    assert out["ok"] and out["bloom_header_opens"] == out["db_files_packed"] >= 1


def test_dry_scheduler_times_its_checkpoints(monkeypatch):
    """Every status-file write is timed, and the wall splits into them and
    the scheduling; the writer is put back after the run."""
    from kwage_tpu_torch.parallel import maestro as maestro_mod

    calls = []
    real = maestro_mod.write_status_file

    def writer(*args):
        calls.append(args[0])
        real(*args)

    monkeypatch.setattr(maestro_mod, "write_status_file", writer)
    out = dry_sched.run(600)
    assert out["ok"] and out["checkpoints"] == len(calls) >= 1
    assert 0 <= out["checkpoint_max_sec"] <= out["checkpoint_sec"] <= out["wall_sec"]
    assert out["schedule_sec"] == pytest.approx(out["wall_sec"] - out["checkpoint_sec"])
    assert maestro_mod.write_status_file is writer


# --- scaling ----------------------------------------------------------------------------------

def test_two_logical_slots_count_as_one(monkeypatch):
    """The mesh path over 2 logical CPU slots equals search_counts over the
    whole matrix on one device."""
    for name, value in (("LOG2_L", 9), ("W_PER_DEV", 8), ("NQ", 2), ("NK", 48)):
        monkeypatch.setattr(scaling, name, value)
    idx, valid = scaling.queries()
    shards = {(CPU, f): scaling.shard(f, CPU) for f in range(2)}
    whole = torch.cat([shards[(CPU, 0)], shards[(CPU, 1)]], dim=1)
    want = ts.search_counts(whole, torch.from_numpy(idx), torch.from_numpy(valid)).numpy()
    mesh = make_search_mesh(1, 2, [CPU, CPU])
    got = to_host(sharded_search_counts(mesh, MeshMatrix(mesh, shards), idx, valid))
    np.testing.assert_array_equal(got, want)
    one = make_search_mesh(1, 1, [CPU])
    got1 = to_host(sharded_search_counts(one, MeshMatrix(one, {(CPU, 0): shards[(CPU, 0)]}),
                                         idx, valid))
    np.testing.assert_array_equal(got1, want[:, :8 * 32])


def test_scaling_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    for name, value in (("LOG2_L", 9), ("W_PER_DEV", 8), ("NQ", 2), ("NK", 48),
                        ("LOGICAL", 2)):
        monkeypatch.setattr(scaling, name, value)
    _few_samples(monkeypatch, scaling)
    assert scaling.main(["--out", str(tmp_path / "sc.json")]) == 0
    points = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
              if '"point"' in x]
    assert [(p["devices"], p["logical"], p["scaling_efficiency"]) for p in points] == [
        (1, False, 1.0), (2, True, None)]
    assert all(p["counts_equal_one_device"] for p in points)


def test_scaling_across_two_processes(tmp_path):
    """The several-process route (parallel/distributed.py): two gloo
    processes of one CPU slot each form the global 1 x 2 mesh; each holds
    its own shard's columns of the gathered counts to search_counts, and
    process 0 alone prints the point. The rendezvous port is taken anew
    when another process took it first (tests/_torch_ports.py)."""
    import sys

    from _torch_ports import run_together, with_fresh_port

    env = {k: v for k, v in os.environ.items() if not k.startswith("KWAGE_")}
    env.update(KWAGE_TORCH_DEVICE="cpu", KWAGE_NUM_PROCESSES="2", SCALING_LOG2_L="9",
               SCALING_W_PER_DEV="8", SCALING_NQ="2", SCALING_NK="48", OMP_NUM_THREADS="1")
    argvs = [[sys.executable, "-m", "kwage_tpu_torch.bench.scaling", "--out",
              str(tmp_path / f"p{i}.json")] for i in range(2)]
    runs = with_fresh_port(lambda port: run_together(
        argvs, [{**env, "KWAGE_COORDINATOR_ADDRESS": f"localhost:{port}",
                 "KWAGE_PROCESS_ID": str(i)} for i in range(2)], timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    outs = [(r.stdout, r.stderr) for r in runs]
    assert [r.returncode for r in runs] == [0, 0], [o[1][-2000:] for o in outs]
    points = [json.loads(x) for x in outs[0][0].splitlines() if '"point"' in x]
    assert [(p["devices"], p["logical"], p["counts_equal_one_device"]) for p in points] == [
        (2, False, True)]
    assert "{" not in outs[1][0]
    assert (tmp_path / "p0.json").exists() and not (tmp_path / "p1.json").exists()


# --- every program: no card, no result -----------------------------------------------------

PROGRAMS = [search_phases, sorted_gather, ingest, build_phases, sriracha_model, scaling,
            dry_sched]


@pytest.mark.parametrize("module", PROGRAMS, ids=[m.__name__.split(".")[-1] for m in PROGRAMS])
def test_program_without_a_card_exits_1(module, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal where there is none")
    monkeypatch.delenv("KWAGE_TORCH_DEVICE")
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert "no CUDA device" in str(e.value.code)
    assert "{" not in capsys.readouterr().out


def test_programs_write_nothing_at_the_working_directory(monkeypatch, tmp_path):
    """Without --out a program writes its list into the temporary
    directory, never into the working directory (the repository)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    monkeypatch.setattr(dry_sched, "N", 300)
    assert dry_sched.main([]) == 0
    assert sorted(os.listdir(tmp_path)) == ["tmp"]
    assert "dry_sched.json" in os.listdir(tmp_path / "tmp")
