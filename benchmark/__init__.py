"""The benchmark of the PyTorch and CUDA port (``kwage_tpu_torch``).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells, metrics and
bounds; ``manifest`` finds each part by name. Nothing here imports JAX or
the JAX package.
"""
