"""The port's benchmark programs, each the counterpart of a JAX program:

- ``python3 -m kwage_tpu_torch.bench.search``: ``bench.py``, k-mer query
  throughput of the search kernels;
- ``python3 -m kwage_tpu_torch.bench.build``: ``bench_build.py``, Bloom
  filters built/s through ``maestro``, host and device;
- ``python3 -m kwage_tpu_torch.bench.serve``: ``tools/bench_resident.py``,
  warm queries/s and latency of ``ResidentSearcher``;
- ``python3 -m kwage_tpu_torch.bench.sriracha``:
  ``tools/bench_sriracha_device.py``, SriRachA's Mbp/s.

Each keeps its JAX program's environment overrides, arguments and result
keys, and runs on the card unless ``KWAGE_TORCH_DEVICE=cpu`` (``_common``).
"""
