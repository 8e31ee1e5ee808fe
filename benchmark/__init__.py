"""The benchmark of latentblending_tpu_torch on NVIDIA GPUs (BENCHMARK.json; run.py)."""
