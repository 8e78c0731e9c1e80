"""The benchmark of magnetite_tpu_torch on one NVIDIA H100: `run.py` runs
one cell of BENCHMARK.json once and prints one JSON result line."""
