"""``device.idle_share.epoch``: ``readers.idle_share``."""
from bench_torch.metrics.readers import idle_share as read  # noqa: F401
