"""Finding the benchmark's parts by name.

``BENCHMARK.json`` at the repository's root lists the cells and metrics. A
cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` (whose ``driver`` names a module of
``drivers/``), and a per-layer metric is ``metrics/<name>.py``, all under
this folder (or under ``root``, which the tests point at a folder of their
own). Adding one of them means adding its file and its entry; no file here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"


def _root(root) -> Path:
    return Path(root) if root else HERE


def load(path=None) -> dict:
    with open(path or MANIFEST) as f:
        return json.load(f)


def config(name: str, root=None) -> dict:
    with open(_root(root) / "configs" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str, root=None) -> dict:
    with open(_root(root) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metric(name: str, root=None):
    """The reader module of per-layer metric ``name``: ``read(record)``
    returns its value or None, ``TIMES`` ({label: "module:attribute"}) names
    the functions of the program it wants timed."""
    path = _root(root) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def cell(doc: dict, name: str) -> dict:
    for w in doc["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end(doc: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in doc["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(doc: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose ``moves`` the cell reports."""
    moves = {m["name"] for m in end_to_end(doc, cell_name)}
    out = []
    for m in doc["per_layer"]:
        listed = m.get("workloads")
        if (cell_name in listed) if listed is not None else (m["moves"] in moves):
            out.append(m)
    return out
