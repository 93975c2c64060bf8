"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's driver (its traffic mix's ``driver``) builds the inputs from the
seed, starts the program, and opens the window once set-up is done:
``setup_s`` is the time from this process's start to that moment. With
``--trace 0`` the last line of standard output reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (read by
``metrics/<name>.py`` from the function timers and the device trace of the
window). Each number that decides ``correct`` is printed beside its limit
as the last lines of standard error, and under ``checks``, the last key of
the result. Without a CUDA device, or with fewer than the cell asks for,
the run prints no result and exits 2; without the program under test
(``kwage_tpu_torch``) beside it, it exits 1. A run after which JAX or the
JAX package is loaded prints no result and exits 3. The program builds its
kernel library into ``build/`` of the checkout, at a fixed path, so only a
checkout's first run builds it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

_T_IMPORT = time.perf_counter()

import torch  # noqa: E402

from . import manifest, trace  # noqa: E402

PROGRAM = "kwage_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "kwage_tpu"}


def process_age_s() -> float:
    """Seconds since this process started (``/proc``); where that cannot
    be read, since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


class Context:
    """What a driver gets: the cell, its configuration and mix, the seed,
    the window's seconds, the device, a work directory, and the window."""

    def __init__(self, cell, cfg, mix, seed, seconds, trace_on, device, workdir, root, timers):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds, self.trace = seed, seconds, trace_on
        self.device, self.workdir = device, workdir
        self.root = str(root) if root else None
        self.timers = timers
        self.window = trace.DeviceWindow(trace_on, workdir)
        self.children: list = []
        self.setup_s = None
        self.window_s = None
        self._age0 = process_age_s() - time.perf_counter()
        self.phases = {"start": self._age0 + time.perf_counter()}
        self._last = time.perf_counter()

    def phase(self, name: str) -> None:
        """Record the seconds since the last phase ended under ``name``."""
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now

    def open_window(self) -> None:
        self.setup_s = self._age0 + time.perf_counter()
        self.window.start()
        if self.timers is not None:
            self.timers.active = True

    def close_window(self) -> None:
        if self.timers is not None:
            self.timers.active = False
        self.window_s = self.window.stop(self.timers)
        self._last = time.perf_counter()


class Record:
    """What a per-layer metric's ``read`` gets."""

    def __init__(self, ctx: Context, result: dict, device_kind: str):
        self.window_s = ctx.window_s
        self.timers = {k: tuple(v) for k, v in (ctx.timers.totals if ctx.timers else {}).items()}
        self.trace = ctx.window.summary
        self.work = result.get("work", {})
        self.end_to_end = dict(result.get("end_to_end", {}))
        self.device_kind = device_kind


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def run_cell(doc: dict, name: str, seed: int, seconds: float, trace_on: bool,
             device: torch.device, root=None) -> dict:
    """One run of cell ``name``; the result line as a dict (without the
    device check that ``main`` makes first)."""
    cell = manifest.cell(doc, name)
    cfg = manifest.config(cell["config"], root)
    mix = manifest.traffic(cell["traffic"], root)
    layer = manifest.per_layer(doc, name) if trace_on else []
    readers = {m["name"]: manifest.metric(m["name"], root) for m in layer}
    targets = dict(mix.get("host_labels", {}))
    for r in readers.values():
        targets.update(getattr(r, "TIMES", {}))
    timers = trace.Timers(targets) if trace_on else None
    workdir = tempfile.mkdtemp(prefix="kwage-bench-")
    ctx = Context(cell, cfg, mix, seed, seconds, trace_on, device, workdir, root, timers)
    try:
        if timers is not None:
            timers.install()
        out = manifest.driver(mix["driver"]).run(ctx)
    finally:
        if timers is not None:
            timers.remove()
        for child in ctx.children:
            if child.poll() is None:
                child.kill()
            child.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    values = dict(out["end_to_end"], setup_s=ctx.setup_s)
    if trace_on:
        rec = Record(ctx, out, kind)
        values = {m: readers[m].read(rec) for m in readers}
        entries = layer
    else:
        entries = manifest.end_to_end(doc, name)
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in entries if values.get(m["name"]) is not None}
    checks = out["checks"]
    correct = all(c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["min"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace_on:
        summary = ctx.window.summary
        result["device"]["busy_s"] = summary.get("busy_s", 0.0)
        result["device"]["window_s"] = ctx.window_s
        result["breakdown"] = {"device_ops": summary.get("device_ops", []),
                               "idle_gaps": summary.get("idle_gaps", [])}
    result["phases_s"] = ctx.phases
    if "thirds_kbp_per_s" in out:
        result["thirds_kbp_per_s"] = out["thirds_kbp_per_s"]
    if out.get("errors"):
        result["errors"] = out["errors"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    doc = manifest.load()
    chips = manifest.cell(doc, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        importlib.import_module(PROGRAM)
    except ImportError as e:
        print(f"the program under test ({PROGRAM}) does not import: {e}", file=sys.stderr)
        return 1
    os.environ["KWAGE_TORCH_DEVICE"] = "cuda"
    result = run_cell(doc, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        bound = f"<= {c['limit']}" if "limit" in c else f">= {c['min']}"
        print(f"check {name}: {c['value']} (limit {bound})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
