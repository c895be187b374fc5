"""The benchmark of respmon_tpu_torch, the PyTorch/CUDA port: see
``BENCHMARK.json`` at the root of the repository and ``run.py``."""
