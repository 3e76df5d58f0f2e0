"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (:mod:`portbench.run`).
The benchmark imports nothing of JAX or of the JAX package, and its plain
references (:mod:`portbench.reference`) nothing of the program either.
"""
