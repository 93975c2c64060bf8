"""Milliseconds of the service's render a request: the time the server's
handler threads spend in ``ResidentSearcher.render`` (query prep, device
search, hit collection and rendering, under the server's lock) over the
window, divided by the renders. The gap to the clients' latency is
transport and the wait for the lock."""

TIMES = {"render": "kwage_tpu_torch.search.resident:ResidentSearcher.render"}


def read(rec):
    seconds, calls = rec.timers.get("render", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
