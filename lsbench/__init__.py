"""The benchmark of ``latentsync_tpu_torch``: lip-sync serving on one card.

``run.py`` runs one cell; a cell is a configuration (``configs/``) under a
traffic mix (``traffic/``), both found by name from ``BENCHMARK.json``.
``metrics/`` holds one reader per per-layer metric, ``counts/`` the
operations, bytes and peaks, ``reference/`` the plain model that decides
``correct``. The harness imports nothing of the JAX package.
"""
