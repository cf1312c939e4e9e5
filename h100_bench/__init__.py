"""The benchmark of rvdd_tpu_torch on NVIDIA H100 cards (``BENCHMARK.json``
at the root names its cells and metrics; ``run.py`` runs one cell once)."""
