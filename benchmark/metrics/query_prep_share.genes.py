"""``query_prep_share``, read the same way, in the cells whose end-to-end
metrics are the tail and set-up alone (``search_p95_ms``, ``setup_s``),
where it moves the tail. Query prep is the largest part of a render."""

from pathlib import Path

from benchmark import manifest

_SAME = manifest.metric("query_prep_share", Path(__file__).resolve().parent.parent)
TIMES = getattr(_SAME, "TIMES", {})
read = _SAME.read
