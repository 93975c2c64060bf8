"""The traced run's reduction: busy time, kernel time, top operations and
idle time by the innermost timed call, on a synthetic trace; and the
function timers, which must leave the program as they found it."""

import json

from benchmark import trace


def test_reduce_a_synthetic_window(tmp_path):
    w = trace.DeviceWindow(True, str(tmp_path))
    w.t0, w.t1 = 100.0, 101.0  # a 1 s window
    timers = trace.Timers({})
    timers.intervals = [(100.0, 100.6, "render"), (100.0, 100.3, "prep"),
                        (100.5, 100.6, "hits")]
    events = [{"name": trace.MARK, "cat": "user_annotation", "ph": "X", "ts": 0.0, "dur": 1e6},
              {"name": "k", "cat": "kernel", "ph": "X", "ts": 3e5, "dur": 1e5},
              {"name": "copy", "cat": "gpu_memcpy", "ph": "X", "ts": 3.5e5, "dur": 1.5e5},
              {"name": "late", "cat": "kernel", "ph": "X", "ts": 2e6, "dur": 1e5},  # past the window
              {"name": "cpu", "cat": "cpu_op", "ph": "X", "ts": 0.0, "dur": 1e6}]
    s = w._reduce(events, timers)
    json.dumps(s)
    assert abs(s["busy_s"] - 0.2) < 1e-9 and abs(s["kernel_s"] - 0.1) < 1e-9
    assert [n for n, _ in s["device_ops"]] == ["copy", "k"]
    gaps = dict(s["idle_gaps"])
    assert set(gaps) == {"prep", "hits", "no timed function"}
    assert abs(gaps["prep"] - 0.3) < 1e-9 and abs(gaps["hits"] - 0.1) < 1e-9
    assert abs(gaps["no timed function"] - 0.4) < 1e-9


def test_timers_count_only_in_the_window_and_restore():
    from benchmark import sequences

    original = sequences.accession
    t = trace.Timers({"acc": "benchmark.sequences:accession"})
    t.install()
    try:
        sequences.accession(1)
        t.active = True
        assert sequences.accession(2) == original(2)
        sequences.accession(3)
        t.active = False
        sequences.accession(4)
    finally:
        t.remove()
    assert sequences.accession is original
    assert t.totals["acc"][1] == 2 and len(t.intervals) == 2
