"""Share of the render's time in query prep: building the ``QueryBatch``
(canonical k-mers, murmur3 rows, padding and upload of the flags) over the
time in ``ResidentSearcher.render``, both summed over the window's
requests in the server's handler threads."""

TIMES = {"render": "kwage_tpu_torch.search.resident:ResidentSearcher.render",
         "query_prep": "kwage_tpu_torch.search.resident:QueryBatch"}


def read(rec):
    render = rec.timers.get("render", (0.0, 0))[0]
    prep = rec.timers.get("query_prep", (0.0, 0))[0]
    return prep / render if render > 0 else None
