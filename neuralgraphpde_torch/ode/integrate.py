"""ODE integration: fixed-grid and adaptive explicit RK (counterpart of
``neuralgraphpde.ode.integrate``), differentiable with autograd.

Conventions as in the JAX package: ``rhs(t, y, args)``, ``y`` a tensor,
``ts`` an increasing 1-D array of save times; results are stacked on a
leading time axis with ``ys[0] == y0``.

Step control runs on the host, one device read per step (the error ratio).
Time, step size, error ratio and the controller's arithmetic stay float32
0-d CPU tensors, as they are in the JAX package (which runs with x64 off),
so both accept the same steps.

Gradients. The JAX package's checkpoint adjoint is the exact gradient of
the discrete solve with every step time and size held constant: it replays
the accepted steps and takes one VJP per step. Autograd through the forward
loop gives the same numbers as long as the controller stays out of the
graph, so the error ratio, the initial step size, ``dt`` and ``t`` are
computed under ``torch.no_grad()`` from detached values. A rejected step is
then referenced by nothing once the next attempt starts, and its stages are
freed. Every accepted step's stages stay alive until the backward pass
(memory grows with the accepted steps; the JAX adjoint replays instead).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .tableaus import Tableau, get_tableau


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _times(ts) -> torch.Tensor:
    return torch.as_tensor(ts, dtype=torch.float32).detach().cpu().reshape(-1)


def _lincomb(coeffs, ks):
    """Σ_i coeffs[i] · ks[i], summed left to right."""
    return sum(c * k for c, k in zip(coeffs, ks))


def _rk_step(rhs, tab: Tableau, t, y, h, f0, args):
    """One explicit RK step from ``(t, y)`` with ``f0 = f(t, y)``. Returns
    ``(y1, err, f_last)``; for FSAL tableaus ``f_last = f(t + h, y1)``.
    The error estimate is computed outside autograd: only the controller
    reads it."""
    hf = float(h)
    ks = [f0]
    for i in range(1, tab.stages):
        incr = _lincomb(tab.a[i], ks[: len(tab.a[i])])
        ks.append(rhs(t + _f32(tab.c[i]) * h, y + hf * incr, args))
    y1 = y + hf * _lincomb(tab.b, ks)
    err = None
    if tab.adaptive:
        with torch.no_grad():
            err = hf * _lincomb(tab.b_err, [k.detach() for k in ks])
    return y1, err, ks[-1]


def odeint_grid(rhs: Callable, y0: torch.Tensor, ts, args=None, *,
                solver="rk4", steps_per_interval: int = 1) -> torch.Tensor:
    """Fixed-step solve hitting every ``ts`` point; each save interval is
    split into ``steps_per_interval`` equal steps."""
    tab = get_tableau(solver)
    ts = _times(ts)
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        t0 = ts[i]
        dt = (ts[i + 1] - t0) / steps_per_interval
        for j in range(steps_per_interval):
            t = t0 + dt * _f32(j)
            y, _, _ = _rk_step(rhs, tab, t, y, dt, rhs(t, y, args), args)
        ys.append(y)
    return torch.stack(ys)


def _rms_host(x: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(x²)) as a float32 CPU scalar (one device read)."""
    return torch.sqrt(torch.sum(x * x) / x.numel()).cpu()


def _error_ratio(err, y0, y1, rtol, atol) -> torch.Tensor:
    """The controller's scaled RMS error, outside autograd."""
    with torch.no_grad():
        scale = atol + rtol * torch.maximum(y0.detach().abs(),
                                            y1.detach().abs())
        return _rms_host(err.detach() / scale)


def _optimal_dt(dt, ratio, order, safety=0.9, min_factor=0.2,
                max_factor=10.0) -> torch.Tensor:
    if ratio <= 1e-10:  # near-zero error: grow at the maximum rate
        factor = _f32(max_factor)
    else:
        factor = torch.clamp(safety * ratio ** (-1.0 / order), min_factor,
                             max_factor)
    return dt * factor


@torch.no_grad()
def _initial_step_size(rhs, t0, y0, f0, args, order, rtol, atol):
    """Hairer-Nørsett-Wanner automatic initial step selection; a constant
    of the solve, so its right-hand-side evaluation records no graph."""
    y0, f0 = y0.detach(), f0.detach()

    def scaled_norm(x, ref):
        return _rms_host(x / (atol + rtol * ref.abs()))

    d0 = scaled_norm(y0, y0)
    d1 = scaled_norm(f0, y0)
    if d0 < 1e-5 or d1 < 1e-5:
        h0 = _f32(1e-6)
    else:
        h0 = 0.01 * d0 / torch.clamp(d1, min=1e-30)
    f1 = rhs(t0 + h0, y0 + float(h0) * f0, args)
    d2 = scaled_norm(f1 - f0, y0) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = torch.clamp(h0 * 1e-3, min=1e-6)
    else:
        h1 = (0.01 / torch.clamp(torch.maximum(d1, d2), min=1e-30)) ** (
            1.0 / (order + 1.0))
    return torch.minimum(100.0 * h0, h1)


def _hermite_eval(t0, y0, f0, t1, y1, f1, t):
    """Cubic Hermite interpolant over ``[t0, t1]`` evaluated at ``t``."""
    h = t1 - t0
    theta = (t - t0) / h
    th2 = theta * theta
    th3 = th2 * theta
    c_y0 = 2.0 * th3 - 3.0 * th2 + 1.0
    c_f0 = h * (th3 - 2.0 * th2 + theta)
    c_y1 = -2.0 * th3 + 3.0 * th2
    c_f1 = h * (th3 - th2)
    return (float(c_y0) * y0 + float(c_f0) * f0 + float(c_y1) * y1
            + float(c_f1) * f1)


class _NanGrad(torch.autograd.Function):
    """Identity whose backward returns NaN: the JAX checkpoint adjoint's
    answer when the solve took more accepted steps than its replay buffer
    holds."""

    @staticmethod
    def forward(ctx, ys):
        return ys.view_as(ys)

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def _odeint_adaptive(rhs, tab: Tableau, rtol, atol, max_steps, chk_steps,
                     y0, ts, args, interpolate: bool, stats: dict):
    """Adaptive solve. ``interpolate=True``: free stepping, saves read off
    the cubic Hermite interpolant of the last accepted step (the JAX
    package's ``hermite``); ``False``: steps clamped to land on each save
    point (``tstop``).

    Gradients are NaN, as in the JAX checkpoint adjoint, when its replay
    could not have reproduced the solve: with Hermite saves, more than
    ``chk_steps`` accepted steps or ``max_steps`` attempts over the whole
    span, or a span not reached; with tstop saves, more than ``chk_steps``
    accepted steps in one interval, or an interval not reached."""
    f0 = rhs(ts[0], y0, args)
    dt = _initial_step_size(rhs, ts[0], y0, f0, args, tab.order, rtol, atol)
    tp, yp, fp = ts[0], y0, f0
    t, y, f = ts[0], y0, f0
    ys = [y0]
    overflow = False
    for target in ts[1:]:
        n = accepted = 0
        while t < target and n < max_steps:
            h = dt if interpolate else torch.minimum(dt, target - t)
            y1, err, f_last = _rk_step(rhs, tab, t, y, h, f, args)
            ratio = _error_ratio(err, y, y1, rtol, atol)
            stats["steps"] += 1
            if ratio <= 1.0:
                f1 = f_last if tab.fsal else rhs(t + h, y1, args)
                tp, yp, fp = t, y, f
                t, y, f = t + h, y1, f1
                stats["accepted"] += 1
                accepted += 1
            dt = _optimal_dt(h, ratio, tab.order)
            n += 1
        if interpolate:
            ys.append(_hermite_eval(tp, yp, fp, t, y, f, target))
        else:
            ys.append(y)
            overflow |= accepted > chk_steps or t < target
    if interpolate:
        overflow = (stats["accepted"] > chk_steps
                    or stats["steps"] > max_steps or t < ts[-1])
    out = torch.stack(ys)
    if overflow and out.requires_grad:
        out = _NanGrad.apply(out)
    return out


def odeint(rhs: Callable, y0: torch.Tensor, ts, args=None, *,
           solver="tsit5", rtol: float = 1e-6, atol: float = 1e-6,
           max_steps: int = 10_000, interpolation: str = "hermite",
           adjoint: str = "checkpoint", checkpoint_steps: int = 128,
           stats: Optional[dict] = None) -> torch.Tensor:
    """Adaptive solve saving at ``ts`` (``ts[0]`` is the initial time).

    ``interpolation="hermite"``: the controller steps freely and each save
    comes from the cubic Hermite dense output of the step that crosses it.
    ``"tstop"``: steps are clamped to land on every save point.

    Gradients flow by autograd through the accepted steps and equal the JAX
    package's ``adjoint="checkpoint"`` (the exact discrete gradient);
    ``checkpoint_steps`` bounds accepted steps as its replay buffer does
    (over the whole span for Hermite saves, per interval for tstop), and a
    solve beyond it returns NaN gradients with unchanged values. The
    continuous ``"backsolve"`` adjoint is not ported: it runs the same
    forward, and raises once the solve would record a graph.

    ``stats``, if given, receives ``nfe`` (right-hand-side evaluations),
    ``steps`` (attempted) and ``accepted``.
    """
    if interpolation not in ("hermite", "tstop"):
        raise ValueError("interpolation must be 'hermite' or 'tstop'")
    if adjoint not in ("checkpoint", "backsolve"):
        raise ValueError("adjoint must be 'checkpoint' or 'backsolve'")
    tab = get_tableau(solver)
    if not tab.adaptive:
        raise ValueError(
            f"solver {tab.name!r} has no embedded error estimate; use "
            "odeint_grid for fixed-step solvers")
    counts = dict(nfe=0, steps=0, accepted=0)

    def counted(t, y, a):
        counts["nfe"] += 1
        dy = rhs(t, y, a)
        if adjoint == "backsolve" and dy.requires_grad:
            raise NotImplementedError(
                "the backsolve adjoint is not ported: differentiate with "
                "adjoint='checkpoint', or solve under torch.no_grad()")
        return dy

    ys = _odeint_adaptive(counted, tab, rtol, atol, max_steps,
                          checkpoint_steps, y0, _times(ts), args,
                          interpolate=interpolation == "hermite",
                          stats=counts)
    if stats is not None:
        stats.update(counts)
    return ys
