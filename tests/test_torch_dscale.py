"""The distributed proof (kwage_tpu_torch.scale.distributed) on the CPU at a
small size, held to kwage_tpu: its corpus is the JAX tool's generation code
run as written; the distributed, single and crash runs commit every
accession with equal result sets, which equal kwage_tpu's maestro and host
engine over the same inputs; kwage-torch --device over the distributed
corpus is the host engine's bytes; the sampled .bloom files equal the exact
ground truth and the host build. No test bounds a wall-clock time."""

import json
import os
import pathlib
import random
import textwrap
import time

import numpy as np
import pytest
import torch

from kwage_tpu.cli.kwage import main as jax_kwage_main
from kwage_tpu.cli.maestro import main as jax_maestro_main
from kwage_tpu.core import FilterInfo as JaxFilterInfo
from kwage_tpu.core import str_to_accession as jax_str_to_accession
from kwage_tpu.io.inventory import write_inventory as jax_write_inventory
from kwage_tpu_torch.cli.kwage import main as torch_kwage_main
from kwage_tpu_torch.scale import _corpus, distributed

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "run_at_scale_distributed.py"


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The CPU, one thread a process (this one and its maestro children):
    several test processes share the machine."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def jax_tool_corpus(work: str, n_acc: int, genome: int, cov: int):
    """The JAX tool's generation block (``rng =`` to the inventory) and its
    query block (``qf =`` to ``def search``), run as written."""
    src = TOOL.read_text()
    gen = src[src.index("    rng = random.Random(20260818)"):
              src.index('    inv = os.path.join(work, "inventory.bin")')]
    query = src[src.index('    qf = os.path.join(work, "q.fasta")'):
                src.index("    def search(dbdir):")]
    ns = dict(random=random, os=os, time=time, work=work, src=os.path.join(work, "src"),
              n_acc=n_acc, genome=genome, cov=cov, FilterInfo=JaxFilterInfo,
              str_to_accession=jax_str_to_accession)
    os.makedirs(ns["src"])
    exec(textwrap.dedent(gen), ns)
    jax_write_inventory(os.path.join(work, "inventory.bin"), ns["infos"])
    exec(textwrap.dedent(query), ns)
    return ns["qf"]


@pytest.mark.parametrize("n_acc,genome,cov", [(7, 400, 3), (12, 3300, 2), (3, 149, 1)])
def test_corpus_is_the_jax_tools(tmp_path, n_acc, genome, cov):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    qf = jax_tool_corpus(str(jax_dir), n_acc, genome, cov)
    got = _corpus.generate_dscale(str(port_dir), n_acc, genome, cov)
    names = sorted(os.listdir(jax_dir / "src"))
    assert names == sorted(os.listdir(got.src)) and len(names) == n_acc
    for name in names:
        assert _read(jax_dir / "src" / name) == _read(os.path.join(got.src, name)), name
    assert _read(jax_dir / "inventory.bin") == _read(got.inv)
    _corpus.write_queries(str(port_dir / "q.fasta"), got.queries)
    assert _read(qf) == _read(port_dir / "q.fasta")


@pytest.mark.parametrize("seed,n", [(20260818, 1), (1, 1000), (7, 33333)])
def test_bulk_choices_replay_random_choice(seed, n):
    """_choices_acgt gives rng.choice("ACGT")'s draws and leaves the
    generator where n such calls would."""
    a, b = random.Random(seed), random.Random(seed)
    a.random()
    b.random()
    want = "".join(a.choice("ACGT") for _ in range(n))
    got = np.frombuffer(b"ACGT", np.uint8)[_corpus._choices_acgt(b, n)].tobytes().decode()
    assert got == want and a.getstate() == b.getstate()


def test_fasta_reads_pad_with_n(tmp_path):
    p = tmp_path / "a.fasta"
    p.write_text(">r0\nACGTAC\n>r1\nGG\n")
    m = _corpus.fasta_reads(str(p))
    assert [r.tobytes() for r in m] == [b"ACGTAC", b"GGNNNN"]


def test_result_set_ignores_hit_order():
    """The JSON renderer's lines, two hits in either order: one set; a hit
    of another run: another set."""
    def render(*hits):
        body = ",".join(f'\n\t\t{{\n\t\t\t"num_kmers_found": {n},\n\t\t\t'
                        f'"run_accession": "{acc}"\n\t\t}}' for acc, n in hits)
        return f'{{\n\t"query": "q0",\n\t"results": [{body}\n\t]\n}}'

    a = render(("SRR1", 3), ("SRR2", 5))
    assert distributed.result_set(a) == distributed.result_set(render(("SRR2", 5), ("SRR1", 3)))
    assert distributed.result_set(a) != distributed.result_set(render(("SRR1", 3), ("SRR3", 5)))
    assert len(distributed.result_set(a)) == 4


@pytest.fixture(scope="module")
def dscale_run(tmp_path_factory):
    """One run of the proof at 14 accessions, one --worker beside the
    coordinator (the crash run keeps the JAX tool's 2), the latency regime
    apart, kept: (workdir, its phase lines, exit code)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KWAGE_TORCH_DEVICE", "cpu")
    mp.setenv("OMP_NUM_THREADS", "1")
    for name, value in (("N_ACC", 14), ("GENOME", 2500), ("COV", 3), ("N_WORKERS", 1),
                        ("SKIP_LATENCY", True)):
        mp.setattr(distributed, name, value)
    work = tmp_path_factory.mktemp("dscale")
    try:
        rc = distributed.main([str(work), "--out", str(work / "lines.json")])
    finally:
        mp.undo()
    return work, json.loads((work / "lines.json").read_text()), rc


def test_distributed_single_and_crash_runs_agree(dscale_run):
    work, lines, rc = dscale_run
    assert rc == 0
    phase = {x["phase"]: x for x in lines}
    for name in ("distributed_run", "single_run", "crash_recovery"):
        assert phase[name]["every_accession_terminal"], name
    assert phase["crash_recovery"]["result_set_equals_single"]
    assert phase["crash_recovery"]["killed_rc"] != 0
    assert phase["search_parity"]["distributed_equals_single"]
    assert phase["search_parity"]["device_byte_identical_to_host"]
    assert phase["blooms"]["equal_ground_truth"] and phase["blooms"]["equal_host_build"]
    assert phase["done"] == {**phase["done"], "ok": True, "cut": ["latency"]}
    assert all(r is not None for r in phase["distributed_run"]["children"])


def test_distributed_result_set_equals_kwage_tpu(dscale_run, tmp_path):
    """kwage_tpu's maestro (the JAX tool's flags) and host engine over the
    same inputs find the same (query, hit) set as the port's distributed run."""
    work, _, rc = dscale_run
    assert rc == 0
    scratch = tmp_path / "jax"
    assert jax_maestro_main([
        "--meta", str(work / "inventory.bin"), "--scratch", str(scratch),
        "--status", str(scratch / "status.bin"), "--source-dir", str(work / "src"),
        "--s3.no-write", "--min-kmer-count", "1", "--len.min", "16", "--len.max", "20"]) == 0
    out = {}
    for name, engine, d in (("jax", jax_kwage_main, scratch / "database"),
                            ("port", torch_kwage_main, work / "dist" / "database")):
        path = tmp_path / f"{name}.json"
        assert engine(["-d", str(d), "-t", "0.8", "-i", str(work / "q.fasta"), "--o.json",
                       "-o", str(path)]) == 0
        out[name] = path.read_text()
    assert distributed.result_set(out["jax"]) == distributed.result_set(out["port"])
    assert "num_kmers_found" in out["jax"]


def test_latency_regime_finishes_every_run(tmp_path, monkeypatch):
    """The download-bound regime at 8 accessions and 2 workers: both runs
    exit 0, every accession ends packed, and a speedup comes out (no bound
    on it here)."""
    corpus = _corpus.generate_dscale(str(tmp_path), 8, 600, 2)
    log = _corpus.PhaseLog(distributed.bench_device())
    for name, value in (("LAT_N", 8), ("LAT_WORKERS", 2), ("LAT_DELAY", 0.05)):
        monkeypatch.setattr(distributed, name, value)

    def maestro_args(scratch, extra, inv=corpus.inv, source=None):
        return ["--meta", inv, "--scratch", scratch, "--status",
                os.path.join(scratch, "status.bin"), *(source or []), "--s3.no-write",
                "--min-kmer-count", "1", "--len.min", "16", "--len.max", "20", *extra]

    ratio = distributed.latency_regime(log, str(tmp_path), corpus, maestro_args)
    assert ratio is not None and ratio > 0
    phase = {x["phase"]: x for x in log.results}
    assert phase["latency_single_run"]["rc"] == 0
    assert phase["latency_distributed_run"]["worker_rcs"] == [0, 0]
    for run in ("lat_single", "lat_dist"):
        assert distributed.all_terminal(str(tmp_path / run), 8), run
