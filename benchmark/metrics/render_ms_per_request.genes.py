"""``render_ms_per_request``, read the same way, in the cells whose end-to-end
metrics are the tail and set-up alone (``search_p95_ms``, ``setup_s``),
where it moves the tail. In a closed loop a request waits for the renders
queued ahead of it, so the render's time sets the tail."""

from pathlib import Path

from benchmark import manifest

_SAME = manifest.metric("render_ms_per_request", Path(__file__).resolve().parent.parent)
TIMES = getattr(_SAME, "TIMES", {})
read = _SAME.read
