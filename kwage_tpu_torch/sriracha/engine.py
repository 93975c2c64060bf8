"""``search_accession`` with its device branch on the port (the JAX
package's engine.search_accession sends ``opt.use_device`` to
kwage_tpu.sriracha.device, which imports jax). Every other path is the
jax-free ``kwage_tpu.sriracha.engine``'s."""

from __future__ import annotations

import os

import numpy as np
import torch

from kwage_tpu.io.sequence import SEQUENCE_EXTS
import kwage_tpu.sriracha.engine as host_engine
from kwage_tpu.sriracha.engine import SearchMatch, SrirachaOptions, StreamStats

from .device import search_reads_device


def search_accession(
    accession_path: str,
    subject_kmers: list[tuple[str, np.ndarray]],
    opt: SrirachaOptions,
    stats: StreamStats | None = None,
    device: torch.device | None = None,
) -> list[list[SearchMatch]]:
    """Search one accession (a local FASTA/FASTQ file or directory); with
    ``opt.use_device`` its reads stream into the port's
    search_reads_device on ``device`` (default ``resolve_device()``),
    otherwise the host engine searches it."""
    if not opt.use_device:
        return host_engine.search_accession(accession_path, subject_kmers, opt, stats)
    path = accession_path
    if os.path.isdir(path):
        # The first sequence file of the directory, as the host engine picks.
        for name in sorted(os.listdir(path)):
            if name.endswith(SEQUENCE_EXTS):
                path = os.path.join(path, name)
                break
    return search_reads_device(
        host_engine.iter_reads_range(path, opt.slice_index, opt.num_slice),
        subject_kmers, opt, stats, device=device,
    )

