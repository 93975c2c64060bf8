"""``search_roofline``, read the same way, in the cells whose end-to-end
metrics are the tail and set-up alone (``search_p95_ms``, ``setup_s``),
where it moves the tail. Those cells search at threshold 1.0, which the
complete-match kernels (``search_complete``) answer."""

from pathlib import Path

from benchmark import manifest

_SAME = manifest.metric("search_roofline", Path(__file__).resolve().parent.parent)
TIMES = getattr(_SAME, "TIMES", {})
read = _SAME.read
