"""Device selection, card identity and shared-secret auth for the port.

``KWAGE_TORCH_DEVICE`` is the port's counterpart of ``JAX_PLATFORMS``: it
names the torch device the device paths run on (default ``cuda``). A
requested CUDA device that is not present is an error -- the port never
carries on on the CPU in its place. The CPU tests set ``cpu`` explicitly,
which routes every kernel wrapper to its plain PyTorch version.
"""

from __future__ import annotations

import os
import subprocess

import torch


def resolve_secret(secret: str | None) -> str:
    """An explicit secret wins; otherwise the KWAGE_QUEUE_SECRET env var;
    empty string = auth disabled."""
    if secret is not None:
        return secret
    return os.environ.get("KWAGE_QUEUE_SECRET", "")


def check_token(msg: dict, secret: str) -> bool:
    """Pop the "token" field from a wire message and verify it against
    the shared secret (constant-time). True when auth is disabled or the
    token matches."""
    import hmac

    token = str(msg.pop("token", ""))
    if not secret:
        return True
    return hmac.compare_digest(token, secret)


def resolve_device(name: str | None = None) -> torch.device:
    """The torch device the device paths run on.

    ``name`` wins; otherwise ``KWAGE_TORCH_DEVICE`` (default ``cuda``).
    Raises when CUDA is asked for and no CUDA device is present. With no
    index given a single-device entry point takes device 0; the search
    entry points shard over every visible device instead
    (``parallel.mesh.default_devices``).
    """
    dev = torch.device(name or os.environ.get("KWAGE_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"KWAGE_TORCH_DEVICE={dev} requested but no CUDA device is "
                "present (set KWAGE_TORCH_DEVICE=cpu to run the plain "
                "PyTorch versions on the CPU)")
        if dev.index is None:
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
