"""Device selection and card identity for the port.

``KWAGE_TORCH_DEVICE`` is the port's counterpart of ``JAX_PLATFORMS``: it
names the torch device the device paths run on (default ``cuda``). A
requested CUDA device that is not present is an error -- the port never
carries on on the CPU in its place. The CPU tests set ``cpu`` explicitly,
which routes every kernel wrapper to its plain PyTorch version.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch


def resolve_device(name: str | None = None) -> torch.device:
    """The torch device the device paths run on.

    ``name`` wins; otherwise ``KWAGE_TORCH_DEVICE`` (default ``cuda``).
    Raises when CUDA is asked for and no CUDA device is present. With
    several CUDA devices and no index given, device 0 is used and a line
    on stderr says so (multi-GPU sharding is not ported yet).
    """
    dev = torch.device(name or os.environ.get("KWAGE_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"KWAGE_TORCH_DEVICE={dev} requested but no CUDA device is "
                "present (set KWAGE_TORCH_DEVICE=cpu to run the plain "
                "PyTorch versions on the CPU)")
        if dev.index is None:
            n = torch.cuda.device_count()
            if n > 1:
                print(f"kwage_tpu_torch: {n} CUDA devices visible; using "
                      "cuda:0 (multi-GPU search is not ported)", file=sys.stderr)
            dev = torch.device("cuda", 0)
    return dev


def card_identity() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card).
    Raises when nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()
