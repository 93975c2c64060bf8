"""SriRachA per-read confirmation search: the host engine, the read
sources and the device search (PyTorch + CUDA port of kwage_tpu/sriracha).
This package never imports jax."""
from .engine import (
    SearchMatch,
    SrirachaOptions,
    assign_read_range,
    extract_sra_accession,
    search_accession,
    search_reads,
)
