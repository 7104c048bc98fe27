"""The benchmark of the PyTorch/CUDA port (``repro_torch`` with its
front door ``canal_torch``) on one NVIDIA H100. ``BENCHMARK.json`` at
the root of the repository names its cells; ``python3 -m canalbench.run``
runs one. See ``canalbench/harness.py``."""
