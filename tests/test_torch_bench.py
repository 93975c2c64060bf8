"""The port's benchmark programs (kwage_tpu_torch.bench) on the CPU: each
runs small under KWAGE_TORCH_DEVICE=cpu (the kernels' plain versions),
prints its JAX program's result keys and loads neither jax nor kwage_tpu;
without a card and without that setting each exits non-zero with no
result. Their workloads equal the JAX programs' (the search workload
through kwage_tpu's searches, bench_build.py's FASTA bytes, the SriRachA
matches of kwage_tpu's device search), and the search bench's ceiling
guard drops impossible samples."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kwage_tpu.ops import search as jax_search
from kwage_tpu.sriracha import device as jax_sriracha
from kwage_tpu.sriracha.engine import SrirachaOptions as JaxSrirachaOptions
from kwage_tpu.sriracha.engine import canonical_kmers as jax_canonical_kmers
from kwage_tpu_torch.bench import _common
from kwage_tpu_torch.bench import build as bench_build
from kwage_tpu_torch.bench import search as bench_search
from kwage_tpu_torch.bench import sriracha as bench_sriracha
from kwage_tpu_torch.kernels.time_kernel import HBM_BYTES_PER_S
from kwage_tpu_torch.ops import search as ts

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

# Appended to a run's code: no jax* and no kwage_tpu[.*] module loaded
# (tests/test_torch_no_jax.py's check).
ASSERT_CLEAN = (
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
    "             or m == 'kwage_tpu' or m.startswith('kwage_tpu.'))\n"
    "assert not bad, bad\n"
)

# (module, argv, env): each bench at a test's size.
SMALL = {
    "search": ([], {"BENCH_LOG2_L": "12", "BENCH_FILES": "1", "BENCH_NQ": "2",
                    "BENCH_NK": "64"}),
    "build": ([], {"BUILD_N_ACC": "4", "BUILD_BP": "20000"}),
    "serve": ([], {"SCALE_N_ACC": "16", "RESIDENT_NQ": "16"}),
    "sriracha": (["21", "128", "64"], {}),
}

# The keys of each JAX program's last line (SriRachA's also the two-launch
# step's kernel_only_mbps_words).
KEYS = {
    "search": {"metric", "value", "unit", "vs_baseline",
               "complete_match_kmer_queries_per_sec", "spread"},
    "build": {"metric", "value", "unit", "mbp_per_sec"},
    "serve": {"phase", "ok"},
    "sriracha": {"metric", "kernel_only_mbps", "kernel_only_mbps_words", "k", "read_len",
                 "reads_timed", "value", "unit", "warmup_compile_s", "timed_s", "matches",
                 "platform"},
}


def _env(device: str | None, extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "KWAGE_TORCH_DEVICE"}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if device is not None:
        env["KWAGE_TORCH_DEVICE"] = device
    env.update(extra)
    return env


def _run_bench(name: str, argv: list[str], env: dict) -> tuple[int, list[str], str]:
    """Run ``python -m kwage_tpu_torch.bench.<name>`` as runpy does, then
    check that no jax or kwage_tpu module was loaded; returns (exit code,
    stdout lines, stderr)."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['kwage_tpu_torch.bench.{name}'] + {argv!r}\n"
        "try:\n"
        f"    runpy.run_module('kwage_tpu_torch.bench.{name}', run_name='__main__',"
        " alter_sys=True)\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)\n"
        "    if not isinstance(e.code, (int, type(None))):\n"
        "        print(e.code, file=sys.stderr)\n"
        + ASSERT_CLEAN
        + "sys.exit(rc)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(REPO), env=env)
    return res.returncode, res.stdout.strip().splitlines(), res.stderr


def _top_files() -> dict:
    return {p.name: (p.stat().st_mtime_ns if p.is_file() else None) for p in REPO.iterdir()}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_bench_runs_on_the_cpu(name):
    argv, extra = SMALL[name]
    before = _top_files()
    rc, lines, err = _run_bench(name, argv, _env("cpu", extra))
    assert rc == 0, err[-3000:]
    last = json.loads(lines[-1])
    assert set(last) == KEYS[name], last
    assert "not a device figure" in json.loads(lines[0])["card"]
    if name == "search":
        assert last["metric"] == "kmer_queries_per_sec_per_chip"
        assert last["value"] > 0 and last["vs_baseline"] > 0
        assert last["complete_match_kmer_queries_per_sec"] > 0
        assert last["spread"]["n"] == bench_search.SAMPLES
        assert last["spread"]["min"] <= last["value"] <= last["spread"]["max"]
        assert "not a device figure" in last["unit"]
    elif name == "build":
        results = [json.loads(line) for line in lines if '"metric"' in line]
        assert [r["metric"] for r in results] == ["bloom_filters_built_per_sec_host",
                                                  "bloom_filters_built_per_sec_device"]
        assert all(r["value"] > 0 and r["mbp_per_sec"] > 0 for r in results)
        runs = [json.loads(line) for line in lines if line.startswith('{"run"')]
        assert [r["run"] for r in runs] == ["host", "device"] * bench_build.ROUNDS
        assert any(line.startswith('{"check"') for line in lines)
    elif name == "serve":
        assert last == {"phase": "done", "ok": True}
        phases = {json.loads(line).get("phase"): json.loads(line) for line in lines}
        batch = phases["resident_batch"]
        assert batch["complete"]["byte_identical_to_host"]
        assert batch["counting"]["byte_identical_to_host"]
        assert set(phases["latency"]["complete"]) == {"1", "8"}
        assert _top_files() == before, "the serve bench wrote into the repository"
    else:
        assert last["platform"] == "cpu" and last["k"] == 21 and last["reads_timed"] == 0
        assert last["kernel_only_mbps"] > 0 and last["kernel_only_mbps_words"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
def test_bench_without_a_card_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal where there is none")
    argv, extra = SMALL[name]
    rc, lines, err = _run_bench(name, argv, _env(None, extra))
    assert rc != 0
    assert not lines, lines
    assert "no CUDA device" in err


def test_search_workload_equals_kwage_tpu():
    db, idx, valid, _ = bench_search.make_workload(CPU, log2_l=12, files=1, nq=2, nk=64)
    words = ts.tensor_to_words(db)
    args_j = (jnp.asarray(words), jnp.asarray(idx), jnp.asarray(valid))
    args_t = (db, torch.from_numpy(idx), torch.from_numpy(valid))
    np.testing.assert_array_equal(ts.search_counts(*args_t).numpy(),
                                  np.asarray(jax_search.search_counts(*args_j)))
    np.testing.assert_array_equal(ts.tensor_to_words(ts.search_complete(*args_t)),
                                  np.asarray(jax_search.search_complete(*args_j)))
    # bench.py's slice indices: numpy's default_rng(0), in its call.
    want = np.random.default_rng(0).integers(0, 1 << 12, size=(2, 64, 5), dtype=np.int32)
    np.testing.assert_array_equal(idx, want)
    assert valid.all()


def test_build_corpus_equals_bench_build():
    """bench_build.py:53-73's numpy calls, reproduced: the same FASTA bytes."""
    n_acc, bp, read_len = 3, 20000, 300
    rng = np.random.default_rng(0)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    want = []
    for i in range(n_acc):
        n_reads = bp // read_len
        genome = lut[rng.integers(0, 4, size=max(bp // 4, read_len), dtype=np.uint8)]
        starts = rng.integers(0, genome.size - read_len + 1, size=n_reads)
        parts = []
        for r, st in enumerate(starts):
            parts += [b">r%d\n" % r, genome[st : st + read_len].tobytes(), b"\n"]
        want.append((f"SRR5{i:06d}", b"".join(parts)))
    got = [(acc, bench_build.fasta_bytes(reads))
           for acc, reads in bench_build.make_corpus(n_acc, bp)]
    assert got == want


def test_sriracha_matches_equal_kwage_tpu():
    """A run whose timed span holds reads (past the 16 x 512 warm-up): its
    matches equal kwage_tpu's device search over the same reads."""
    k, read_len, n_reads = 11, 128, bench_sriracha.SPAN + 64
    rc, lines, err = _run_bench("sriracha", [str(k), str(read_len), str(n_reads), "lut"],
                                _env("cpu", {}))
    assert rc == 0, err[-3000:]
    last = json.loads(lines[-1])
    assert last["reads_timed"] == 64

    subjects, reads = bench_sriracha.make_inputs(k, read_len, n_reads, 2048)
    # The JAX tool's subjects: kwage_tpu's canonical k-mers of the same draws.
    rng = np.random.default_rng(7)
    bases = np.array(list("ACGT"))
    for name, kmers in subjects:
        seq = "".join(bases[rng.integers(0, 4, size=2048 + k - 1)])
        np.testing.assert_array_equal(kmers, np.unique(jax_canonical_kmers(seq, k)))
    stream = [(seq, i, 0) for i, seq in enumerate(reads)][bench_sriracha.SPAN:]
    res = jax_sriracha.search_reads_device(stream, subjects, JaxSrirachaOptions(kmer_len=k),
                                           batch_size=512, span_reads=bench_sriracha.SPAN)
    assert last["matches"] == sum(len(r) for r in res)


def test_ceiling_guard_rejects_impossible_samples(capsys):
    nbytes = 83_886_080
    at_rate = nbytes / HBM_BYTES_PER_S * 1e3          # ms at exactly 3.35 TB/s
    samples = [at_rate * 2, at_rate / 1.04, at_rate / 1.06, at_rate, at_rate * 1.5]
    kept = _common.hold_to_ceiling("search_counts", samples, nbytes)
    assert kept == [at_rate * 2, at_rate / 1.04, at_rate, at_rate * 1.5]
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["kept"] for line in lines] == [True, True, False, True, True]
    assert lines[2]["share_of_hbm"] == pytest.approx(1.06)


def test_ceiling_guard_drops_samples_that_are_not_positive(capsys):
    """A time of 0 or below (two host-clock readings out of order) could
    not have happened: dropped and printed as not kept, as a sample above
    the ceiling is, with no rate."""
    nbytes = 1 << 20
    slow = nbytes / (0.5 * HBM_BYTES_PER_S) * 1e3
    assert _common.hold_to_ceiling("x", [slow, 0.0, slow, -slow, slow], nbytes) == [slow] * 3
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["kept"] for line in lines] == [True, False, True, False, True]
    assert lines[1]["bytes_per_s"] is None and lines[3]["share_of_hbm"] is None
    assert not _common.possible(0.0, 0) and _common.possible(slow, nbytes)


def test_ceiling_guard_fails_with_fewer_than_three_left(capsys):
    nbytes = 1 << 20
    fast = nbytes / (1.2 * HBM_BYTES_PER_S) * 1e3
    slow = nbytes / (0.5 * HBM_BYTES_PER_S) * 1e3
    assert _common.hold_to_ceiling("x", [fast, fast, slow, slow, slow], nbytes) == [slow] * 3
    with pytest.raises(_common.BenchFailure) as e:
        _common.hold_to_ceiling("x", [fast, fast, fast, slow, slow], nbytes)
    assert e.value.code != 0 and "fewer than 3" in str(e.value)
    capsys.readouterr()


def test_ceiling_guard_bytes_a_call():
    nq, nk, nh, files = 8, 1024, 5, 8
    w = 64 * files
    assert bench_search.gathered_bytes(nq * nk, nh, w) == nq * nk * nh * w * 4 == 83_886_080
    ceiling_ms = bench_search.gathered_bytes(nq * nk, nh, w) / HBM_BYTES_PER_S * 1e3
    assert ceiling_ms == pytest.approx(0.02504, abs=5e-6)
    assert nq * nk * files / (ceiling_ms * 1e-3) == pytest.approx(2.617e9, rel=1e-3)
