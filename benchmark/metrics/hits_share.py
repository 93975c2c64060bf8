"""Share of the render's time in hit collection and rendering:
``chunk_hits`` (the device result to per-file hits), ``collect_results``
(the output order, the runs' metadata) and ``render_json`` over the time
in ``ResidentSearcher.render``, summed over the window's requests."""

TIMES = {"render": "kwage_tpu_torch.search.resident:ResidentSearcher.render",
         "chunk_hits": "kwage_tpu_torch.search.resident:chunk_hits",
         "collect_results": "kwage_tpu_torch.search.resident:collect_results",
         "render_json": "kwage_tpu_torch.search.resident:render_json"}


def read(rec):
    render = rec.timers.get("render", (0.0, 0))[0]
    hits = sum(rec.timers.get(k, (0.0, 0))[0]
               for k in ("chunk_hits", "collect_results", "render_json"))
    return hits / render if render > 0 else None
