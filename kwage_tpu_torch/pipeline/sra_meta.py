"""Accession size metadata without reading the sequence data.

The reference probes ``STATS/TABLE/BASE_COUNT`` in the SRA VDB metadata
tree (sra_meta.cpp:17-122) so the counting filter can be pre-sized before
any read is streamed. This engine's equivalents:

- local FASTA/FASTQ(.gz) files: one streaming pass counting bases/spots;
- SRA accessions: the reference's exact KMetadata read through the
  libncbi-vdb ctypes layer when the library is present
  (sriracha/vdb.py:vdb_number_of_bases), else shell out to the SRA
  toolkit's ``sra-stat -x`` (same numbers, subprocess cost).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import xml.etree.ElementTree as ET

from ..io.sequence import iter_sequences


def number_of_bases(path: str) -> tuple[int, int]:
    """(base_count, spot_count) of a local sequence file, one streaming pass."""
    num_bp = 0
    num_spots = 0
    for _, seq in iter_sequences(path):
        num_bp += len(seq)
        num_spots += 1
    return num_bp, num_spots


def sra_number_of_bases(accession: str) -> tuple[int, int]:
    """(base_count, spot_count) for an SRA accession, zero reads streamed.

    Prefers the direct ``STATS/TABLE`` KMetadata read (the reference's
    path, sra_meta.cpp:17-122) via the libncbi-vdb ctypes layer; falls
    back to a ``sra-stat -x`` subprocess probe. Raises RuntimeError when
    neither is available or both fail -- callers fall back to buffering
    the stream (the same behavior the reference has when the metadata
    node is missing).
    """
    if os.environ.get("KWAGE_NO_VDB") != "1":
        from ..sriracha import vdb

        if vdb.meta_available():
            try:
                return vdb.vdb_number_of_bases(accession)
            except vdb.DownloadError:
                pass  # node missing / open failure: try the toolkit probe
    exe = shutil.which("sra-stat")
    if exe is None:
        raise RuntimeError(
            "sra-stat not found: SRA metadata probing requires the SRA toolkit"
        )
    proc = subprocess.run(
        [exe, "-x", "-s", accession], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(f"sra-stat failed for {accession}: {proc.stderr.strip()}")
    root = ET.fromstring(proc.stdout)
    # <Run ... spot_count="N" base_count="M" ...>
    try:
        return int(root.attrib["base_count"]), int(root.attrib["spot_count"])
    except (KeyError, ValueError) as e:
        raise RuntimeError(f"sra-stat output missing counts for {accession}") from e
