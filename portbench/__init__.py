"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA
device and prints one JSON result line; ``portbench/README.md`` describes
the layout and how a cell, a configuration, a traffic mix or a per-layer
metric is added as new files.
"""
