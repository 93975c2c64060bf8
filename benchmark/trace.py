"""What a traced run (``--trace 1``) reads: function timers and the device
trace of the window.

``Timers`` wraps functions of the program, named "module:attribute.path" by
the per-layer metrics' ``TIMES``, and sums the seconds and calls of each
while the window is open, in whichever thread calls them; it keeps each
call's interval too, so that the device's idle gaps can be labelled by what
the host was doing. ``DeviceWindow`` runs ``torch.profiler`` over the window
and reduces its trace: the union of the device's kernel, copy and set
intervals (busy seconds), the union of kernels alone, the operations that
took most time, and the device's idle time cut at the edges of the timed
calls and summed by the innermost timed call running in each piece.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import threading
import time
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "benchmark.window"
TOP = 10


def _resolve(target: str):
    """(owner object, attribute name) of "module:attr.path"."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Timers:
    def __init__(self, targets: dict[str, str]):
        self.targets = targets
        self.active = False
        self.totals = defaultdict(lambda: [0.0, 0])
        self.intervals: list[tuple[float, float, str]] = []
        self._lock = threading.Lock()
        self._saved = []

    def install(self) -> None:
        for label, target in self.targets.items():
            owner, name = _resolve(target)
            fn = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(label, fn))

    def remove(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()

    def _wrap(self, label: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    tot = self.totals[label]
                    tot[0] += t1 - t0
                    tot[1] += 1
                    self.intervals.append((t0, t1, label))
        return timed


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceWindow:
    """The measured window; with ``trace``, under ``torch.profiler``."""

    def __init__(self, trace: bool, workdir: str):
        self.trace, self.workdir = trace, workdir
        self.summary: dict = {}

    def start(self) -> None:
        if self.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._mark = record_function(MARK)
            self._mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, timers: Timers | None = None) -> float:
        """Close the window; return its seconds (and reduce the trace)."""
        self.t1 = time.perf_counter()
        if self.trace:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._mark.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            path = os.path.join(self.workdir, "window_trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(path)
            self.summary = self._reduce(events, timers)
        return self.t1 - self.t0

    def _reduce(self, events: list, timers: Timers | None) -> dict:
        mark = [e for e in events if e.get("name") == MARK and e.get("cat") == "user_annotation"]
        if not mark:
            return {}
        T0 = float(mark[0]["ts"])
        T1 = T0 + (self.t1 - self.t0) * 1e6
        dev, kern, by_op = [], [], defaultdict(float)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = max(float(e["ts"]), T0)
            b = min(float(e["ts"]) + float(e.get("dur", 0)), T1)
            if b <= a:
                continue
            dev.append((a, b))
            if e["cat"] == "kernel":
                kern.append((a, b))
            by_op[e["name"][:160]] += (b - a) * 1e-6
        busy = _union(dev)
        g0 = np.array([T0] + [b for _, b in busy])
        g1 = np.array([a for a, _ in busy] + [T1])
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        # Cut the idle gaps at every edge of a timed call, and give each
        # piece to the innermost timed call (the shortest) that covers it.
        spans = defaultdict(list)
        for a, b, label in (timers.intervals if timers is not None else []):
            spans[label].append((T0 + (a - self.t0) * 1e6, T0 + (b - self.t0) * 1e6))
        unions = {label: np.array(_union(iv)) for label, iv in spans.items()}
        edges = np.unique(np.concatenate([g0, g1] + [u.ravel() for u in unions.values()]))
        mids = (edges[:-1] + edges[1:]) / 2
        lengths = np.diff(edges)
        i = np.searchsorted(g0, mids, side="right") - 1
        idle = (i >= 0) & (mids < g1[np.maximum(i, 0)])
        mids, lengths = mids[idle], lengths[idle]
        best = np.full(len(mids), np.inf)
        label_at = np.full(len(mids), "no timed function", dtype=object)
        for label, u in unions.items():
            j = np.searchsorted(u[:, 0], mids, side="right") - 1
            ok = (j >= 0) & (mids <= u[np.maximum(j, 0), 1])
            span = np.where(ok, u[np.maximum(j, 0), 1] - u[np.maximum(j, 0), 0], np.inf)
            better = span < best
            best[better] = span[better]
            label_at[better] = label
        gaps = defaultdict(float)
        for label, g in zip(label_at, lengths * 1e-6):
            gaps[label] += float(g)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        return {
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernel_s": sum(b - a for a, b in _union(kern)) * 1e-6,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
                          if s >= 1e-6],
        }
