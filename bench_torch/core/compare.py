"""The numbers that decide ``correct``, each against its limit.

Training (the first three steps, driven in set-up through the window's own
step, against the plain reference from the same inputs and weights):

- ``loss_gap``: the largest over the three steps of ``|L − L_ref| /
  |L_ref|``, and ``first_loss_gap`` the first step's alone (a cell's
  limits file names the numbers it compares);
- ``grad_gap``: the first gradient as the optimizer got it (worked out
  from its state after one step), by the worst leaf: ``|‖g‖ − ‖g_ref‖| /
  max(‖g_ref‖, the median leaf's ‖g_ref‖)``;
- ``change_gap``: the parameters' change over the three steps, by the
  worst leaf, in the same measure, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (the others move
  by round-off alone).

Rollouts: ``traj_gap``, the largest over the sampled requests of
``max|u − u_ref| / max|u_ref|`` over the trajectory's first saves (the
cell's ``saves_compared`` after the initial field, all where it is 0): a
trained surrogate's rollout grows a rounding-sized difference at its start
by 10^4 and more by its end, so the reference in float64 departs from the
reference in float32 as far as the control does there (PERF.md §2).

A reading that is not finite is infinite, and fails.
"""
from __future__ import annotations

import math
import statistics

import torch

SMALL_GRAD = 1e-3


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    p, r = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in
                                                       keys})
    med = statistics.median(r.values())
    gaps = [abs(p[k] - r[k]) / max(r[k], med, 1e-300) for k in keys]
    return _finite(max(gaps)) if all(map(math.isfinite, gaps)) else math.inf


def training(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses`` (three floats), ``grads`` and
    ``change`` (leaf name → tensor)."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 ref["losses"])]
    keys = list(ref["grads"])
    g_ref = _norms(ref["grads"])
    med = statistics.median(g_ref.values())
    moving = [k for k in keys if g_ref[k] >= SMALL_GRAD * med]
    return dict(loss_gap=_finite(max(steps)), first_loss_gap=_finite(steps[0]),
                grad_gap=_leaf_gap(prog["grads"], ref["grads"], keys),
                change_gap=_leaf_gap(prog["change"], ref["change"], moving))


def by_save(prog: list, ref: list) -> list:
    """For each save, the largest over the requests of ``max|u − u_ref|``
    at that save over ``max|u_ref|`` of the whole trajectory."""
    gaps = torch.stack([(p - r).abs().amax(dim=tuple(range(1, p.dim())))
                        / r.abs().max() for p, r in zip(prog, ref)])
    return [_finite(float(v)) for v in gaps.amax(dim=0)]


def trajectories(prog: list, ref: list, saves: int = 0) -> dict:
    gaps = by_save(prog, ref)
    gaps = gaps[: saves + 1] if saves else gaps
    return dict(traj_gap=max(gaps) if all(map(math.isfinite, gaps))
                else math.inf)


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, compared)``: every number at most its limit;
    ``compared`` maps each name to its number and its limit."""
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in compared.values())
    return ok, compared
