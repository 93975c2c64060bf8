"""Percent of the HBM roofline in the window's searches: the bytes the
window's requests must move at the least (``work.search_bytes``: each
valid k-mer's rows over every searched word, its row indices, the result)
over the device time of all kernels in the window (the union of their
intervals in the trace) and the card's published HBM rate. Defined by the
work, not by kernel names, so it reads the same whatever implements the
search."""

from benchmark.work import PEAKS


def read(rec):
    nbytes = rec.work.get("search_bytes")
    kernel_s = rec.trace.get("kernel_s", 0.0)
    peak = PEAKS.get(rec.device_kind, {}).get("hbm_bytes_per_s")
    if not nbytes or kernel_s <= 0 or peak is None:
        return None
    return 100.0 * nbytes / (kernel_s * peak)
