"""kwage_tpu_torch: the PyTorch + CUDA port of kwage_tpu for NVIDIA Hopper.

A second package beside ``kwage_tpu`` (which stays the reference). It
covers the engine's core path on one GPU:

- ``kwage_tpu_torch.ops.transpose`` -- the packed filter -> bit-slice
  transpose (CUDA kernel ``csrc/bit_transpose.cu``);
- ``kwage_tpu_torch.pipeline.build_db`` -- .bloom files -> .db through it;
- ``kwage_tpu_torch.ops.search`` -- the complete-match and counting search
  reductions (CUDA kernels ``csrc/search.cu``) and the fused multi-file
  search;
- ``kwage_tpu_torch.search.resident`` -- the device-resident JSON-lines
  server;
- ``kwage_tpu_torch.cli.kwage`` -- the ``kwage`` CLI with ``--device`` and
  ``--serve`` routed to the above;
- ``kwage_tpu_torch.ops.{kmers,hashing,counting}`` -- canonical k-mers,
  murmur, exact-count thresholding and the filter bit set (CUDA kernels
  ``csrc/kmers.cu``, ``murmur.cu``, ``counting.cu``, ``bitset.cu``);
- ``kwage_tpu_torch.pipeline.make_bloom`` and ``parallel.maestro`` -- the
  device Bloom filter build and the Maestro scheduler on it;
- ``kwage_tpu_torch.cli.maestro`` -- ``kwage-maestro`` with
  ``--device-build`` and ``--device-transpose`` routed to the above;
- ``kwage_tpu_torch.entry`` -- the single-device forward step.

The host layers with no jax in them (``kwage_tpu.core``, ``io``,
``native``, ``search.engine``, ``search.output``, the host transpose) are
imported, not copied. This package never imports jax.
"""

from kwage_tpu import (  # noqa: F401 -- re-exported version identifiers
    INVENTORY_VERSION,
    KWAGE_VERSION,
    MAESTRO_VERSION,
    SRIRACHA_VERSION,
)
