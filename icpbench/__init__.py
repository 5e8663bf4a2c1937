"""The benchmark of simpleicp_tpu_torch on an NVIDIA H100: cells named in
``BENCHMARK.json``, run by ``icpbench/run.py``."""
