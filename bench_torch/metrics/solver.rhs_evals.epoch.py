"""``solver.rhs_evals.epoch``: ``readers.rhs_evals``."""
from bench_torch.metrics.readers import rhs_evals as read  # noqa: F401
