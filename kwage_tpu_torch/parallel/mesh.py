"""Device mesh construction for sharded search (PyTorch port of
kwage_tpu/parallel/mesh.py).

Two logical axes:
- ``data``    -- query batch parallelism (each slot searches its own query
                 rows against its filter shard),
- ``filters`` -- corpus width: the signature matrix is sharded by packed
                 filter words (the counterpart of the reference's
                 <=2048-filter database files searched independently,
                 options.h:137-138 / kwage.cpp:76-151).

The mesh is a ``[num_data, num_filter_shards]`` grid of ``torch.device``.
A device may stand in the grid more than once: several logical shards on
one card, or on the CPU. That is how one card (or none) drives the mesh
path, the counterpart of JAX's forced host device count. A mesh that spans
processes (``parallel.distributed``) also records which process owns each
slot; a process computes its own slots only.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class SearchMesh:
    """A ``[data, filters]`` grid of torch devices.

    ``devices[d][f]`` is the device of slot (d, f); ``owners[d][f]`` the
    rank of the process that holds it (all 0 in a single process), and
    ``rank`` this process's. ``shape`` maps the axis names to their sizes.
    """

    axis_names = ("data", "filters")

    def __init__(self, devices, owners=None, rank: int = 0):
        grid = np.empty((len(devices), len(devices[0])), dtype=object)
        for d, row in enumerate(devices):
            if len(row) != grid.shape[1]:
                raise ValueError("mesh rows differ in length")
            for f, dev in enumerate(row):
                grid[d, f] = torch.device(dev)
        self.devices = grid
        self.owners = (np.zeros(grid.shape, dtype=np.int64) if owners is None
                       else np.asarray(owners, dtype=np.int64).reshape(grid.shape))
        self.rank = rank
        self.shape = {"data": grid.shape[0], "filters": grid.shape[1]}
        self._streams: dict = {}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def spans_processes(self) -> bool:
        return bool((self.owners != self.rank).any())

    def is_local(self, d: int, f: int) -> bool:
        return int(self.owners[d, f]) == self.rank

    def local_slots(self) -> list[tuple[int, int]]:
        """This process's slots (d, f), data-major."""
        return [(d, f) for d in range(self.shape["data"]) for f in range(self.shape["filters"])
                if self.is_local(d, f)]

    def stream(self, d: int, f: int):
        """The CUDA stream slot (d, f) launches on (one a slot, made at
        first use, so that logical shards of one card can overlap); None
        for a CPU slot."""
        dev = self.devices[d, f]
        if dev.type != "cuda":
            return None
        if (d, f) not in self._streams:
            self._streams[(d, f)] = torch.cuda.Stream(dev)
        return self._streams[(d, f)]


def default_devices() -> list[torch.device]:
    """Every visible CUDA device, or the CPU when KWAGE_TORCH_DEVICE=cpu
    (``utils.runtime.resolve_device`` raises when CUDA is asked for and
    absent); KWAGE_TORCH_DEVICE=cuda:i names that card alone."""
    from ..utils.runtime import resolve_device

    name = os.environ.get("KWAGE_TORCH_DEVICE", "cuda")
    dev = resolve_device(name)
    if dev.type != "cuda" or torch.device(name).index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_search_mesh(
    num_data: int = 1, num_filter_shards: int | None = None, devices=None
) -> SearchMesh:
    """A ``num_data`` x ``num_filter_shards`` mesh over ``devices`` (default:
    ``default_devices()``), row-major. List a device several times for
    logical shards on it."""
    devices = default_devices() if devices is None else [torch.device(d) for d in devices]
    n = len(devices)
    if num_filter_shards is None:
        num_filter_shards = n // num_data
    if num_data * num_filter_shards != n:
        raise ValueError(
            f"mesh {num_data}x{num_filter_shards} != {n} devices"
        )
    return SearchMesh([devices[d * num_filter_shards:(d + 1) * num_filter_shards]
                       for d in range(num_data)])
