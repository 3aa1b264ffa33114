"""The benchmark of the PyTorch port ``dgdm_tpu_torch``: ``run.py`` runs
one cell of ``BENCHMARK.json``; see ``harness.py`` for how a cell's files
are found."""
