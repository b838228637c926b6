"""The benchmark of the PyTorch and CUDA port, ``radiocore_tpu_torch``.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``README.md`` says how
cells, traffic mixes and metrics are found by name. Nothing here imports
JAX or the JAX package.
"""
