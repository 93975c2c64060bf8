"""The port's benchmark programs, each the counterpart of a JAX program:

- ``python3 -m kwage_tpu_torch.bench.search``: ``bench.py``, k-mer query
  throughput of the search kernels;
- ``python3 -m kwage_tpu_torch.bench.build``: ``bench_build.py``, Bloom
  filters built/s through ``maestro``, host and device;
- ``python3 -m kwage_tpu_torch.bench.serve``: ``tools/bench_resident.py``,
  warm queries/s and latency of ``ResidentSearcher``;
- ``python3 -m kwage_tpu_torch.bench.sriracha``:
  ``tools/bench_sriracha_device.py``, SriRachA's Mbp/s;
- ``python3 -m kwage_tpu_torch.bench.search_phases``:
  ``tools/bench_search_phases.py``, the search call split into its gather,
  seed AND and merges;
- ``python3 -m kwage_tpu_torch.bench.sorted_gather``:
  ``tools/exp_sorted_gather.py``, random against sorted row orders;
- ``python3 -m kwage_tpu_torch.bench.ingest``: ``tools/bench_ingest.py``,
  the counting chain's Mbp/s with the host out of it;
- ``python3 -m kwage_tpu_torch.bench.build_phases``:
  ``tools/bench_build_phases.py``, a device-build batch step by step;
- ``python3 -m kwage_tpu_torch.bench.sriracha_model``:
  ``tools/bench_sriracha_model.py``, SriRachA's span terms and their model;
- ``python3 -m kwage_tpu_torch.bench.scaling``: ``bench_scaling.py``, weak
  scaling over the mesh's "filters" axis.

Each keeps its JAX program's environment overrides, arguments and result
keys, and runs on the card unless ``KWAGE_TORCH_DEVICE=cpu`` (``_common``).
"""
