"""The general harness: cells are data (``BENCHMARK.json``, the files under
``configs/``, ``traffic/`` and ``workloads/``), found by name."""
