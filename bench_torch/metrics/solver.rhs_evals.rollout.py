"""``solver.rhs_evals.rollout``: ``readers.rhs_evals``."""
from bench_torch.metrics.readers import rhs_evals as read  # noqa: F401
