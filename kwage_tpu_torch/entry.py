"""Single-device forward step of the port: the counterpart of
``entry()`` in the repository's ``__graft_entry__.py``.

The step is the device query pipeline: ASCII query bytes -> canonical
k-mers (canonical_kmers kernel) -> slice indices (murmur32 kernel) ->
gather + AND over a packed signature matrix -> per-filter hit counts
(search_counts kernel). The example arguments are the JAX entry's, made
from the same seed, on ``resolve_device()``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.hashing import slice_indices
from .ops.kmers import canonical_kmers
from .ops.search import search_counts, words_to_tensor
from .utils.runtime import resolve_device

K = 31
NUM_HASH = 5
LOG2_L = 14            # 16384 slice rows
W = 8                  # 256 filters packed into uint32 words
QLEN = 256


def forward(db: torch.Tensor, query_ascii: torch.Tensor) -> torch.Tensor:
    """Hit counts int32 [1, W*32] of one ASCII query uint8 [QLEN]."""
    words, valid = canonical_kmers(query_ascii, K)
    idx = slice_indices(words, K, NUM_HASH, LOG2_L)
    return search_counts(db, idx[None], valid[None])


def entry(device: torch.device | None = None):
    """(forward, example_args): a random signature matrix int32 [2^14, 8]
    and a random ASCII-ish query, both on ``device``."""
    device = resolve_device() if device is None else device
    rng = np.random.default_rng(0)
    db = words_to_tensor(rng.integers(0, 1 << 32, size=(1 << LOG2_L, W), dtype=np.uint32), device)
    query = torch.from_numpy(rng.integers(65, 85, size=QLEN, dtype=np.uint8)).to(device)
    return forward, (db, query)
