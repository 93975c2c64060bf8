"""Whole runs of the tiny cells on the CPU (``run_cell`` without the look
for a card): the result line's shape, ``correct`` on a sound run, and
``correct`` false with the served path broken underneath."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import manifest, run

REPO = manifest.HERE.parent
SEED = 2**31 + 101
CPU = torch.device("cpu")


def _run(tiny, cell, trace=False, seconds=1.5):
    root, doc = tiny
    return run.run_cell(doc, f"tiny.{cell}", SEED, seconds, trace, CPU, root)


@pytest.mark.parametrize("cell", ["genomes-t0.8", "genes-t1"])
def test_sound_run_is_correct(tiny, cell):
    r = _run(tiny, cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device", "phases_s",
                      "thirds_kbp_per_s", "checks"}
    assert r["attempted"] > 0 and r["failed"] == 0
    # The gene panels' rate spreads too widely for an end-to-end bound: that
    # cell reports it per layer and keeps the tail end to end.
    e2e = {"genomes-t0.8": {"search_kbp_per_s", "search_p95_ms", "setup_s"},
           "genes-t1": {"search_p95_ms", "setup_s"}}[cell]
    assert set(r["metrics"]) == e2e
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["metrics"]["search_p95_ms"]["unit"] == "ms"
    assert r["checks"]["compared_hits"]["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_traced_run_reports_per_layer_metrics(tiny):
    root, doc = tiny
    r = _run(tiny, "genes-t1", trace=True)
    assert r["correct"]
    names = {m["name"] for m in manifest.per_layer(doc, "tiny.genes-t1")}
    assert set(r["metrics"]) <= names
    # The host's shares and the render time read on the CPU; what needs
    # the card's trace (roofline, idle share) is left out, never 0.
    assert {"render_ms_per_request.genes", "query_prep_share.genes", "hits_share.genes",
            "served_kbp_per_s.genes"} <= set(r["metrics"])
    assert 0 < r["metrics"]["query_prep_share.genes"]["value"] < 1
    assert r["metrics"]["served_kbp_per_s.genes"]["value"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] >= 1.5
    assert list(r)[-1] == "checks"


def _broken(monkeypatch, fault):
    from kwage_tpu_torch.search import resident

    search = resident.ResidentSearcher.search
    last = {}

    def faulty(self, queries, threshold):
        if fault == "half":       # half of the batch left out
            return search(self, queries[: len(queries) // 2], threshold)
        res = search(self, queries, threshold)
        if fault == "stale":      # the previous request's answer returned
            prev, last["res"] = last.get("res", res), res
            return prev
        if fault == "altered":    # one answer altered where it is produced
            for qid in sorted(res):
                if res[qid]:
                    res[qid][0].num_kmers_found -= 1
                    break
        return res

    monkeypatch.setattr(resident.ResidentSearcher, "search", faulty)


@pytest.mark.parametrize("fault", ["half", "stale", "altered"])
def test_broken_path_is_not_correct(tiny, monkeypatch, fault):
    _broken(monkeypatch, fault)
    r = _run(tiny, "genes-t1", seconds=1.0)
    assert not r["correct"]
    assert r["checks"]["mismatched_queries"]["value"] > 0


@pytest.mark.parametrize("cell", ["genomes-t0.8", "genes-t1"])
def test_control_run_is_not_correct(tiny, cell):
    """The control as a whole run: the reference at every second k-mer in
    the searcher's place; the run's own check says not correct."""
    from benchmark import control
    from kwage_tpu_torch.search.resident import ResidentSearcher

    root, doc = tiny
    program = ResidentSearcher.search
    r = control.readings(doc, f"tiny.{cell}", SEED, 1.0, CPU, root)
    assert ResidentSearcher.search is program
    assert not r["correct"] and r["attempted"] > 0
    assert r["checks"]["mismatched_queries"]["value"] > 0
    assert r["checks"]["failed_requests"]["value"] == 0


def test_control_at_full_precision_is_correct(tiny):
    """The same substitution at every k-mer answers as the program does,
    so the control fails by its precision alone."""
    from benchmark import control

    root, doc = tiny
    restore = control.reference_in_place(manifest.config("tiny", root), CPU, kmer_step=1)
    try:
        r = run.run_cell(doc, "tiny.genes-t1", SEED, 1.0, False, CPU, root)
    finally:
        restore()
    assert r["correct"], r["checks"]


def test_no_card_no_result():
    """Without a CUDA device the run prints nothing on stdout and exits 2."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "viral-L18.genomes-t0.8", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_a_run_loads_no_jax(tiny, tmp_path):
    """After a whole tiny run no loaded module's top-level name is jax,
    jaxlib, flax or kwage_tpu (compared whole: kwage_tpu_torch is the
    program)."""
    root, doc = tiny
    (tmp_path / "doc.json").write_text(json.dumps(doc))
    code = (
        "import json, sys, torch\n"
        "from benchmark import run\n"
        f"doc = json.load(open({str(tmp_path / 'doc.json')!r}))\n"
        f"r = run.run_cell(doc, 'tiny.genes-t1', 5, 1.0, False, torch.device('cpu'), {root!r})\n"
        "assert 'kwage_tpu_torch' in sys.modules\n"
        "print(json.dumps({'correct': r['correct'], 'loaded': run.forbidden_modules()}))\n")
    env = dict(os.environ, KWAGE_TORCH_DEVICE="cpu")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "loaded": []}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kwage_tpu_torchish", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kwage_tpu.core", sys)
    assert run.forbidden_modules() == ["kwage_tpu.core"]


@pytest.mark.cuda
def test_tiny_run_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root, doc = tiny
    r = run.run_cell(doc, "tiny.genomes-t0.8", SEED, 2.0, True, torch.device("cuda", 0), root)
    assert r["correct"] and r["device"]["busy_s"] > 0
