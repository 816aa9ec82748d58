"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once. Nothing here imports JAX or
the JAX package, and nothing here is imported by the program.
"""
