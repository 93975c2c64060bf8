"""Share of the window in which no kernel, copy or set ran on the card:
1 - (union of the device's intervals in the profiler's trace) / window."""


def read(rec):
    busy = rec.trace.get("busy_s")
    if not busy or not rec.window_s:
        return None
    return 1.0 - busy / rec.window_s
