"""What the port's benchmark programs share: the device they run on, the
card's identity, medians and spreads, the memory-rate ceiling a search
sample is held to, and the exact ground truth of one accession's filter.

A program runs on the card (``KWAGE_TORCH_DEVICE``, default ``cuda``) and
exits non-zero, printing no result, where there is none. With
``KWAGE_TORCH_DEVICE=cpu`` it runs the kernels' plain PyTorch versions on
the CPU, for the tests; its figures are then the CPU's and say so.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile

import numpy as np
import torch

from ..core.params import (
    DEFAULT_FALSE_POSITIVE_PROBABILITY,
    DEFAULT_MAX_LOG_2_FILTER_LEN,
    DEFAULT_MIN_LOG_2_FILTER_LEN,
    BloomParam,
    optimal_bloom_param,
)
from ..kernels.time_kernel import HBM_BYTES_PER_S
from ..native import canonical_kmers_native, murmur32_native
from ..utils.runtime import resolve_device

# A sample that is not positive, or whose effective rate is above
# CEILING_SLACK x the card's memory rate, cannot have happened; a run keeps
# at least MIN_SAMPLES.
CEILING_SLACK = 1.05
MIN_SAMPLES = 3


class BenchFailure(SystemExit):
    """A bench's own check failed: raised out of ``main``, it ends the
    program with exit code 1 and its message on stderr."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise BenchFailure(f"bench: {msg}")


def bench_device() -> torch.device:
    """The device the bench runs on (``resolve_device``); without a card and
    without ``KWAGE_TORCH_DEVICE=cpu`` the program exits 1 with the reason."""
    try:
        return resolve_device()
    except RuntimeError as e:
        raise BenchFailure(f"bench: {e}") from None


def card_identity() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card).
    Raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def print_device(device: torch.device) -> str:
    """Print the line every bench starts with and return its label: what
    the figures were measured on, the card's name and power limit or the
    CPU, whose figures are no device's."""
    label = (card_identity() if device.type == "cuda"
             else "CPU, plain PyTorch versions (not a device figure)")
    print(json.dumps({"device": str(device), "card": label, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    return label


def phase_log(device: torch.device):
    """The device line (``print_device``), then a ``scale._corpus.PhaseLog``
    that stamps every phase line with the card's name and power limit (or
    the CPU's note)."""
    from ..scale._corpus import PhaseLog

    return PhaseLog(device, {"card": print_device(device)})


def out_arg(doc: str, argv: list[str] | None) -> argparse.Namespace:
    """A program's ``--out PATH`` (its phase lines as one JSON list)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--out", help="where to write the phase lines as one JSON list "
                                  "(default: NAME.json in the temporary directory)")
    return ap.parse_args(argv)


def out_path(out: str | None, name: str, work: str | None = None) -> str:
    """``out``, else ``name``.json in ``work`` (default: the temporary
    directory): never the working directory, which may be the repository."""
    return out or os.path.join(work or tempfile.gettempdir(), f"{name}.json")


def median_spread(values: list[float]) -> dict:
    """{"n", "min", "median", "max"} of the values (bench.py's ``spread``)."""
    return {"n": len(values), "min": min(values), "median": statistics.median(values),
            "max": max(values)}


def possible(ms: float, bytes_per_call: int) -> bool:
    """Whether a call that moves ``bytes_per_call`` bytes could have taken
    ``ms``: a positive time, no shorter than those bytes at CEILING_SLACK x
    the card's memory rate."""
    return ms > 0 and bytes_per_call <= ms * 1e-3 * CEILING_SLACK * HBM_BYTES_PER_S


def held_sample(what: str, i: int, ms: float, bytes_per_call: int) -> bool:
    """Print sample ``i`` of ``what`` on a JSON line of its own: its time,
    its effective bytes/s and share of the card's memory rate, and whether
    it is kept (``possible``). Returns that."""
    ok = possible(ms, bytes_per_call)
    rate = bytes_per_call / (ms * 1e-3) if ms > 0 else None
    print(json.dumps({"sample": what, "i": i, "ms_per_call": ms, "bytes_per_s": rate,
                      "share_of_hbm": None if rate is None else rate / HBM_BYTES_PER_S,
                      "kept": ok}), flush=True)
    return ok


def hold_to_ceiling(what: str, samples_ms: list[float], bytes_per_call: int) -> list[float]:
    """Print each sample (``held_sample``); drop, and print as rejected, a
    sample that could not have happened: not positive, or above
    CEILING_SLACK x the card's memory rate. Returns the samples kept; fails
    the run when fewer than MIN_SAMPLES are left."""
    kept = [ms for i, ms in enumerate(samples_ms) if held_sample(what, i, ms, bytes_per_call)]
    check(len(kept) >= MIN_SAMPLES,
          f"{what}: {len(samples_ms) - len(kept)} of {len(samples_ms)} samples not positive or "
          f"above {CEILING_SLACK} x {HBM_BYTES_PER_S:.4g} B/s; fewer than {MIN_SAMPLES} left")
    return kept


def exact_bloom(reads: np.ndarray, k: int, min_count: int,
                p: float = DEFAULT_FALSE_POSITIVE_PROBABILITY,
                min_log_2_filter_len: int = DEFAULT_MIN_LOG_2_FILTER_LEN,
                max_log_2_filter_len: int = DEFAULT_MAX_LOG_2_FILTER_LEN,
                ) -> tuple[BloomParam, np.ndarray, np.ndarray]:
    """The exact ground truth of one accession's filter: its reads (ASCII
    uint8 [n, read length]) joined with N, every canonical k-mer counted
    exactly, the words seen ``min_count`` times or more (returned too)
    hashed into an image of the adaptive shape (packed bits, LSB first)."""
    joined = np.concatenate([reads, np.full((reads.shape[0], 1), ord("N"), np.uint8)], axis=1)
    uniq, counts = np.unique(canonical_kmers_native(joined.tobytes(), k), return_counts=True)
    kept = uniq[counts >= min_count]
    param = optimal_bloom_param(k, int(kept.size), p,
                                min_log_2_filter_len=min_log_2_filter_len,
                                max_log_2_filter_len=max_log_2_filter_len)
    image = np.zeros(param.filter_len, bool)
    image[(murmur32_native(kept, k, param.num_hash)
           & np.uint32(param.filter_len - 1)).reshape(-1)] = True
    return param, np.packbits(image, bitorder="little"), kept

