"""Gather / segment reductions onto receiver rows (counterparts of
``neuralgraphpde.ops.scatter``). Empty segments take the reduction's
identity: 0 for sum and mean, 1 for prod, -inf for max, +inf for min."""
from __future__ import annotations

from typing import Callable, Union

import torch

Reduction = Union[str, Callable]

_ALIASES = {
    "+": "sum", "add": "sum", "sum": "sum",
    "*": "prod", "mul": "prod", "prod": "prod",
    "max": "max", "min": "min", "mean": "mean",
}


def canonical_reduction(aggr: Reduction) -> str:
    if callable(aggr):
        name = getattr(aggr, "__name__", None)
        if name in _ALIASES:
            return _ALIASES[name]
        raise ValueError(f"unsupported aggregation callable {aggr}")
    if aggr in _ALIASES:
        return _ALIASES[aggr]
    raise ValueError(f"unsupported aggregation {aggr!r}")


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]``: edge expansion of node features."""
    return x.index_select(0, idx)


def segment_sum(values, segment_ids, num_segments):
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids, values)


def segment_mean(values, segment_ids, num_segments):
    total = segment_sum(values, segment_ids, num_segments)
    counts = segment_sum(values.new_ones(values.shape[0]), segment_ids,
                         num_segments).clamp_min(1)
    return total / counts.reshape((-1,) + (1,) * (values.dim() - 1))


def _scatter_reduce(values, segment_ids, num_segments, how, init):
    out = values.new_full((num_segments,) + tuple(values.shape[1:]), init)
    idx = segment_ids.to(torch.int64).reshape(
        (-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, idx, values, how, include_self=True)


def segment_max(values, segment_ids, num_segments):
    return _scatter_reduce(values, segment_ids, num_segments, "amax",
                           float("-inf"))


def segment_min(values, segment_ids, num_segments):
    return _scatter_reduce(values, segment_ids, num_segments, "amin",
                           float("inf"))


def segment_prod(values, segment_ids, num_segments):
    return _scatter_reduce(values, segment_ids, num_segments, "prod", 1.0)


_SEGMENT_FNS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
    "prod": segment_prod,
}


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, aggr: Reduction = "sum") -> torch.Tensor:
    """Reduce ``(num_edges, ...)`` values onto ``num_segments`` rows."""
    fn = _SEGMENT_FNS[canonical_reduction(aggr)]
    return fn(values, segment_ids, num_segments)
