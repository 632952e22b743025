"""``conv_roofline.epoch``: ``readers.conv_roofline``."""
from bench_torch.metrics.readers import conv_roofline as read  # noqa: F401
