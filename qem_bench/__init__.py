"""The benchmark of ``mlqem_tpu_torch`` on NVIDIA GPUs.

``python -m qem_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
cell or metric is a file of its own, found by its name (see README.md).
"""
