"""The benchmark of ``cosy_tpu_torch`` on one NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``portbench/README.md``).  The
harness reads everything that belongs to one configuration, traffic mix,
per-layer metric or kernel from files under this folder, found by the
names in ``BENCHMARK.json``.  It imports neither JAX nor the JAX package.
"""
