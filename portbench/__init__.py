"""The benchmark of the PyTorch port, ``repic_tpu_torch`` (see
``run.py``; the cells are in ``BENCHMARK.json`` at the repository's
root)."""
