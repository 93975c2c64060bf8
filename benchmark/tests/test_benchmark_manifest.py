"""BENCHMARK.json against the benchmark's contract, and finding its parts by
name: every cell's configuration, mix and driver, every metric's reader,
and a configuration, mix and metric added from a folder of their own."""

import json
import os
import re

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
REPO = manifest.HERE.parent


@pytest.fixture(scope="module")
def doc():
    return manifest.load()


def test_top_level_keys(doc):
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["benchmark"]
    assert 1 <= doc["run_seconds"] <= 51 and isinstance(doc["run_seconds"], int)
    assert len(doc["command"]) <= 32
    assert os.path.getsize(manifest.MANIFEST) <= 64 << 10


def test_full_check_fits_the_day(doc):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 spare."""
    assert (2 + 14 * 24) * (doc["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(doc):
    entries = doc["configs"] + doc["workloads"] + doc["end_to_end"] + doc["per_layer"]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(doc):
    used = {w["config"] for w in doc["workloads"]}
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(REPO / c["file"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = manifest.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert cfg["filters_per_file"] % 32 == 0
        assert cfg["files"] * cfg["filters_per_file"] == cfg["lineages"] * cfg["runs_per_lineage"]


def test_filter_shape_is_the_solvers(doc):
    """L and h are what KWAGE's solver picks for the genome's k-mers."""
    from kwage_tpu_torch.core.params import optimal_bloom_param

    for c in doc["configs"]:
        cfg = manifest.config(c["name"])
        p = optimal_bloom_param(cfg["k"], cfg["genome_len"] - cfg["k"] + 1,
                                cfg["false_positive_probability"])
        assert (p.log_2_filter_len, p.num_hash) == (cfg["log2_filter_len"], cfg["num_hash"])


def test_cells_and_their_parts(doc):
    pairs = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = manifest.traffic(w["traffic"])
        assert hasattr(manifest.driver(mix["driver"]), "run")
        e2e = [m["name"] for m in manifest.end_to_end(doc, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(doc, w["name"])


def test_bounds(doc):
    for m in doc["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in doc["end_to_end"])


def test_per_layer_metrics_have_readers(doc):
    cells = {w["name"] for w in doc["workloads"]}
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells and w in e2e[m["moves"]].get("workloads", [w])
        reader = manifest.metric(m["name"])
        assert callable(reader.read)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layers_are_named_alike(doc):
    """Metrics of one layer give the same layer, letter for letter."""
    by_module = {}
    for m in doc["per_layer"]:
        by_module.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path, doc):
    """Add a configuration, a mix and a metric from a folder of their own:
    the harness finds each by name, and no file of the benchmark changes."""
    before = {p: p.stat().st_mtime_ns for p in manifest.HERE.rglob("*") if p.is_file()}
    for d in ("configs", "traffic", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "dummy-cfg.json").write_text(
        json.dumps(dict(manifest.config("viral-L18"), name="dummy-cfg", files=1)))
    (tmp_path / "traffic" / "dummy-mix.json").write_text(
        json.dumps(dict(manifest.traffic("genes-t1"), threshold=0.9)))
    (tmp_path / "metrics" / "dummy.metric.py").write_text(
        "TIMES = {}\n\ndef read(rec):\n    return 42.0\n")
    new = dict(doc, workloads=doc["workloads"] + [
        {"name": "dummy-cfg.dummy-mix", "config": "dummy-cfg", "traffic": "dummy-mix",
         "chips": 1, "why": "added by files alone"}],
        per_layer=doc["per_layer"] + [
        {"name": "dummy.metric", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "dummy", "moves": "setup_s"}])
    assert manifest.config("dummy-cfg", tmp_path)["files"] == 1
    assert manifest.traffic("dummy-mix", tmp_path)["threshold"] == 0.9
    assert manifest.metric("dummy.metric", tmp_path).read(None) == 42.0
    # A metric without a list is reported in every cell that reports its
    # ``moves``: the new cell and the old ones alike.
    assert "dummy.metric" in [m["name"] for m in manifest.per_layer(new, "dummy-cfg.dummy-mix")]
    assert "dummy.metric" in [m["name"] for m in manifest.per_layer(new, doc["workloads"][0]["name"])]
    assert manifest.cell(new, "dummy-cfg.dummy-mix")["config"] == "dummy-cfg"
    after = {p: p.stat().st_mtime_ns for p in manifest.HERE.rglob("*") if p.is_file()
             if "__pycache__" not in p.parts}
    assert {p: t for p, t in before.items() if "__pycache__" not in p.parts} == after

