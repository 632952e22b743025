"""One reader per per-layer metric, ``<metric name>.py``, each with
``read(ctx) -> float | None``. ``ctx`` is what a traced run collected
(``core/train.py``, ``core/rollout.py``); a reader that finds nothing to
read returns None and the metric is left out of the line."""
