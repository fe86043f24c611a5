"""The benchmark of ``ascendpathtracing_tpu_torch`` on one CUDA device.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line; see
``perfbench/README.md``.  Cells, configurations, traffic kinds and
per-layer metrics are files found by name; the plain reference in
``perfbench/reference`` imports nothing of the program.
"""
