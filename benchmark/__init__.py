"""The benchmark of the PyTorch and CUDA port ``gpbayestools_hic_tpu_torch``.

``run.py`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything that belongs to one configuration, cell, timed loop or
per-layer metric is a file of its own, found by name: ``configs/``,
``workloads/``, ``drivers/``, ``metrics/``.  ``work/`` counts the
algorithm's operations and bytes, ``reference/`` is the plain float64
reference that decides ``correct``, ``harness/`` holds what every cell
shares.  Nothing here imports JAX or the JAX package.
"""
