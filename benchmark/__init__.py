"""The benchmark of the PyTorch/CUDA port (``ammcnet_aaai2021_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``benchmark.control``
reads the controls and planted faults the correctness limits are set
between.  Everything a cell needs is found by the names in the manifest
(see ``harness.py``).  Nothing here imports JAX or the JAX package.
"""
