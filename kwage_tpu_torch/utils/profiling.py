"""Profiling helpers: wall-clock scopes + on-demand device traces.

The reference's only instrumentation is MPI_Wtime deltas shipped in
worker replies (worker_main.cpp:141, SURVEY.md section 5.1). This engine
keeps those counters (maestro logs) and adds:

- ``scope(name)``: a wall-clock context manager accumulating per-name
  totals/counts (queryable via ``report()``);
- ``device_trace(dir)``: a torch.profiler trace (Chrome trace JSON),
  enabled globally by setting KWAGE_TRACE_DIR before launching any CLI.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

_LOCK = threading.Lock()
_TOTALS: dict[str, tuple[float, int]] = {}


@contextlib.contextmanager
def scope(name: str):
    """Accumulate wall-clock time under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            total, count = _TOTALS.get(name, (0.0, 0))
            _TOTALS[name] = (total + dt, count + 1)


def report() -> dict[str, dict[str, float]]:
    """{name: {total_sec, count, mean_sec}} for every recorded scope."""
    with _LOCK:
        return {
            name: {"total_sec": t, "count": c, "mean_sec": t / max(c, 1)}
            for name, (t, c) in sorted(_TOTALS.items())
        }


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Capture a device trace (``<dir>/trace_<pid>.json``, Chrome format).

    No-op when neither ``trace_dir`` nor $KWAGE_TRACE_DIR is set, so call
    sites can wrap hot sections unconditionally.
    """
    trace_dir = trace_dir or os.environ.get("KWAGE_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))
