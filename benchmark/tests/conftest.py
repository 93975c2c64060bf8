"""A tiny copy of the benchmark's cells, in a folder of its own, for the
CPU tests: the real traffic mixes and metric readers at a corpus of 2 files
of 64 runs (L=14, h=3) and short queries."""

import json
import os
import shutil

import pytest

from benchmark import manifest

TINY = {"log2_filter_len": 14, "num_hash": 3, "files": 2, "filters_per_file": 64,
        "lineages": 4, "runs_per_lineage": 32, "genome_len": 1500,
        "run_substitution_rate": 0.002}


def make_root(path) -> dict:
    """Write the tiny parts under ``path``; return their BENCHMARK.json."""
    for d in ("configs", "traffic", "metrics"):
        os.makedirs(os.path.join(path, d), exist_ok=True)
    for m in os.listdir(manifest.HERE / "metrics"):
        if m.endswith(".py"):
            shutil.copy(manifest.HERE / "metrics" / m, os.path.join(path, "metrics", m))
    cfg = dict(manifest.config("viral-L18"), name="tiny", **TINY)
    with open(os.path.join(path, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    for name, extra in (("genomes-t0.8", {}),
                        ("genes-t1", {"min_len": 100, "max_len": 800, "queries_per_request": 8})):
        with open(os.path.join(path, "traffic", f"{name}.json"), "w") as f:
            json.dump(dict(manifest.traffic(name), **extra), f)
    doc = manifest.load()
    cells = [{"name": "tiny.genomes-t0.8", "config": "tiny", "traffic": "genomes-t0.8",
              "chips": 1, "why": "tiny"},
             {"name": "tiny.genes-t1", "config": "tiny", "traffic": "genes-t1",
              "chips": 1, "why": "tiny"}]
    doc = dict(doc, workloads=cells,
               configs=[dict(doc["configs"][0], name="tiny", file="configs/tiny.json")])
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w.replace("viral-L18", "tiny").replace("viral-L20", "tiny")
                              for w in m["workloads"]]
    return doc


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_benchmark")
    return str(root), make_root(str(root))


@pytest.fixture(autouse=True)
def _plain_versions(monkeypatch):
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
