"""``device_idle_share.search``, read the same way, in the cells whose end-to-
end metrics are the tail and set-up alone (``search_p95_ms``, ``setup_s``),
where it moves the tail. The card idles while the host renders."""

from pathlib import Path

from benchmark import manifest

_SAME = manifest.metric("device_idle_share.search", Path(__file__).resolve().parent.parent)
TIMES = getattr(_SAME, "TIMES", {})
read = _SAME.read
