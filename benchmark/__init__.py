"""The benchmark of the PyTorch / CUDA port (``csm_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the CUDA card and prints one JSON
result line.  See ``benchmark/README.md``.  Nothing here imports JAX or the
JAX package.
"""
