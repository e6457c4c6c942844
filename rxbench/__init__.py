"""Benchmark of the PyTorch/CUDA receiver ``gnsslib_tpu_torch``.

``python3 -m rxbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
one JSON line.  Configurations, traffic mixes and per-layer metric readers
are files of their own, found by name (:mod:`rxbench.catalog`).  Nothing
here imports JAX or the JAX package.
"""
