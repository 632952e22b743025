"""Benchmark of the PyTorch and CUDA port (``neuralgraphpde_torch``) on one
H100: the harness (``core/``), the configurations (``configs/``), their
plain references (``reference/``), the traffic mixes (``traffic/``) and one
reader per per-layer metric (``metrics/``). Run one cell once with

    python3 bench_torch/run.py --workload NAME --seed N --seconds S --trace 0|1

Nothing here imports ``jax`` or the JAX package.
"""
