"""The port's at-scale proofs and its parity soak, each the counterpart of a
JAX program:

- ``python3 -m kwage_tpu_torch.scale.at_scale``: ``tools/run_at_scale.py``,
  L=18 at 4350 accessions (two full 2048-filter files, a halted run and
  its restart, the merge of the partials, host and device search);
- ``python3 -m kwage_tpu_torch.scale.prod_l``:
  ``tools/run_at_scale_prodL.py`` and ``tools/run_prodL_device.py``, the
  filter length pinned to 26 (one full 16 GiB quota file), the device
  search streaming it, the mesh wave plan and the device build at L=26;
- ``python3 -m kwage_tpu_torch.scale.soak``: ``tools/soak_parity.py``,
  randomized parity of the device filter, the device search and the host
  engine (and the reference binary, where it is built);
- ``python3 -m kwage_tpu_torch.scale.distributed``:
  ``tools/run_at_scale_distributed.py``, the work queue's coordinator and
  device worker processes, a killed worker and the latency regime;
- ``python3 -m kwage_tpu_torch.scale.dry_sched``: ``tools/dry_sched_50k.py``,
  the scheduler alone at 50,000 accessions.

Each keeps its JAX program's environment knobs and defaults, runs on the
card unless ``KWAGE_TORCH_DEVICE=cpu`` (and raises without one), prints
one JSON line a phase and writes nothing into the working directory.
"""
