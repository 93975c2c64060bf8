"""What the port's benchmark programs share: the device they run on, the
card's identity, medians and spreads, the memory-rate ceiling a search
sample is held to, and the exact ground truth of one accession's filter.

A program runs on the card (``KWAGE_TORCH_DEVICE``, default ``cuda``) and
exits non-zero, printing no result, where there is none. With
``KWAGE_TORCH_DEVICE=cpu`` it runs the kernels' plain PyTorch versions on
the CPU, for the tests; its figures are then the CPU's and say so.
"""

from __future__ import annotations

import json
import statistics
import subprocess

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

# A sample whose effective rate is above CEILING_SLACK x the card's memory
# rate cannot have happened; a run keeps at least MIN_SAMPLES.
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


def median_spread(values: list[float]) -> dict:
    """{"n", "min", "median", "max"} of the values (bench.py's ``spread``)."""
    return {"n": len(values), "min": min(values), "median": statistics.median(values),
            "max": max(values)}


def hold_to_ceiling(what: str, samples_ms: list[float], bytes_per_call: int) -> list[float]:
    """Print each sample's effective bytes/s (``bytes_per_call`` over its
    time) and its share of the card's memory rate; drop, and print as
    rejected, a sample above CEILING_SLACK x that rate, which no card
    could reach. Returns the samples kept; fails the run when fewer than
    MIN_SAMPLES are left."""
    limit = CEILING_SLACK * HBM_BYTES_PER_S
    kept = []
    for i, ms in enumerate(samples_ms):
        rate = bytes_per_call / (ms * 1e-3)
        ok = rate <= limit
        print(json.dumps({"sample": what, "i": i, "ms_per_call": ms, "bytes_per_s": rate,
                          "share_of_hbm": rate / HBM_BYTES_PER_S,
                          "kept": ok}), flush=True)
        if ok:
            kept.append(ms)
    check(len(kept) >= MIN_SAMPLES,
          f"{what}: {len(samples_ms) - len(kept)} of {len(samples_ms)} samples above "
          f"{CEILING_SLACK} x {HBM_BYTES_PER_S:.4g} B/s; fewer than {MIN_SAMPLES} left")
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

