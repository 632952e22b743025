"""``step.mfu.epoch``: ``readers.mfu``."""
from bench_torch.metrics.readers import mfu as read  # noqa: F401
