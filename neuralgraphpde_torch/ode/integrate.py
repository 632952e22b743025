"""ODE integration: fixed-grid and adaptive explicit RK (counterpart of
``neuralgraphpde.ode.integrate``), differentiable with autograd.

Conventions as in the JAX package: ``rhs(t, y, args)``, ``y`` a tensor,
``ts`` an increasing 1-D array of save times; results are stacked on a
leading time axis with ``ys[0] == y0``.

Step control runs on the host, one device read per step (the error ratio).
Time, step size, error ratio and the controller's arithmetic stay float32
0-d CPU tensors, as they are in the JAX package (which runs with x64 off),
so both accept the same steps.

Every vector operation on the state is one combination of
``kernels.rk_kernels`` (on the card, one pass over memory in a
hand-written kernel; on the CPU, the eager composition): each stage input
``y + h·Σ a_ij k_j``, the new state (for Tsit5 and dopri5, whose last stage
row equals ``b``, the last stage input itself), the error estimate with its
scaled RMS norm, the initial step's norms and ``y0 + h0·f0``, and each
Hermite save. Each rounds as the eager composition did, so the values are
those of ``y + h·sum(a·k)`` (the norm's sum of squares is taken in another
order on the card). Under autograd the stages of one step share a
``StageTape``, whose backward writes each stage derivative's cotangent
once.

With autograd off, a solve on the card whose right-hand side is declared
to be a module of the state alone (``rhs.autonomous``, which
``NeuralGraphODE`` sets) runs each attempted step as one replay of a
captured CUDA graph (``attempt_graph``): the stage combinations, the
right-hand-side evaluations and the error norm, with the step size as a
device scalar. The same kernels run on the same values, so the steps and
saves are the eager path's bits; the controller, the initial step and the
saves stay on the host.

Under a profiler each solve runs in an ``ngpde.solve`` span (a backsolve's
backward: one per save interval), each attempted step in
``ngpde.solver.attempt`` with its error ratio and next step size in
``ngpde.solver.control``, and each counted right-hand-side evaluation in
``ngpde.rhs`` (``utils.profiling``); a replayed attempt is one
``ngpde.dispatch.attempt_graph`` span, its evaluations open none.

Gradients, as in the JAX package, by one of two adjoints:

- ``backsolve`` (``odeint``'s default): the continuous adjoint. The forward
  solve runs outside autograd and keeps only the saves; the backward
  integrates the augmented state ``[y, ȳ, t̄, θ̄]`` backwards in ``s = −t``
  between the saves with the same tableau and tolerances (steps clamped to
  the save points), one ``torch.autograd.grad`` of the right-hand side per
  evaluation. Memory is O(1) in steps. ``θ`` are the tensors the
  right-hand side is differentiated in: those of ``args`` that require
  grad, and the leaves it closes over (``jax.closure_convert``'s part),
  found by walking the graph of one recorded evaluation.
- ``checkpoint``: the exact gradient of the discrete solve with every step
  time and size held constant, which the JAX package gets by replaying the
  accepted steps with one VJP per step. Autograd through the forward loop
  gives the same numbers as long as the controller stays out of the graph,
  so the error ratio, the initial step size, ``dt`` and ``t`` are computed
  under ``torch.no_grad()`` from detached values. A rejected step is then
  referenced by nothing once the next attempt starts, and its stages are
  freed. Every accepted step's stages stay alive until the backward pass
  (memory grows with the accepted steps; the JAX adjoint replays instead).
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Callable, List, Optional

import torch

from ..kernels import rk_kernels as rk
from ..nn.graphed import CapturedCall, capture_key
from ..utils.profiling import annotate
from .tableaus import Tableau, get_tableau

SOLVE, RHS = "ngpde.solve", "ngpde.rhs"


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _times(ts) -> torch.Tensor:
    return torch.as_tensor(ts, dtype=torch.float32).detach().cpu().reshape(-1)


@functools.lru_cache(maxsize=None)
def _plan(tab: Tableau):
    """The tableau's combinations, each as (k indices, coefficients) of its
    nonzero coefficients (a term c·k with c = 0 adds ±0 after the leading
    0, which leaves a finite sum's bits as they are): the stage inputs
    ``rows[i]``, the solution weights, whether the last stage input is the
    new state (its row equals ``b``: Tsit5 and dopri5), and the error
    weights."""

    def nonzero(coeffs):
        pairs = [(j, c) for j, c in enumerate(coeffs) if c != 0]
        return (tuple(j for j, _ in pairs), tuple(c for _, c in pairs))

    rows = [nonzero(row) for row in tab.a]
    b = nonzero(tab.b)
    reuse = tab.stages > 1 and rows[-1] == b
    err = nonzero(tab.b_err) if tab.adaptive else None
    return rows, b, reuse, err


def _counted(stats: Optional[dict], fn, *args):
    """``fn(*args)``, one combination of the solve: counted in
    ``stats['combos']`` and, where it launched a kernel,
    ``stats['combos_fused']``."""
    if stats is None:
        return fn(*args)
    before = rk.rk_combine.launches + rk.rk_norm.launches
    out = fn(*args)
    stats["combos"] += 1
    stats["combos_fused"] += (rk.rk_combine.launches + rk.rk_norm.launches
                              > before)
    return out


def _rk_step(rhs, tab: Tableau, t, y, h, f0, args, stats=None, hk=None):
    """One explicit RK step from ``(t, y)`` with ``f0 = f(t, y)``. Returns
    ``(y1, ks)``, the stage derivatives ``ks`` (for FSAL tableaus
    ``ks[-1] = f(t + h, y1)``). Each stage input is one combination; when
    the last one is the new state (``_plan``), it is ``y1``. Under autograd
    the step's stages share one ``StageTape``. ``hk``: the step size as the
    kernels take it where it is not ``float(h)``, an attempt graph's device
    scalar (``_attempt``)."""
    rows, b, reuse, _ = _plan(tab)
    tape = rk.StageTape(float(h) if hk is None else hk)
    ks = [f0]
    z = None
    for i in range(1, tab.stages):
        js, cs = rows[i]
        z = _counted(stats, tape.stage, i, y, js, cs, [ks[j] for j in js])
        ks.append(rhs(t + _f32(tab.c[i]) * h, z, args))
    if not reuse:
        js, cs = b
        z = _counted(stats, tape.stage, tab.stages, y, js, cs,
                     [ks[j] for j in js])
    return z, ks


def odeint_grid(rhs: Callable, y0: torch.Tensor, ts, args=None, *,
                solver="rk4", steps_per_interval: int = 1) -> torch.Tensor:
    """Fixed-step solve hitting every ``ts`` point; each save interval is
    split into ``steps_per_interval`` equal steps."""
    tab = get_tableau(solver)
    ts = _times(ts)

    def spanned(t, y, a):
        with annotate(RHS):
            return rhs(t, y, a)

    ys = [y0]
    y = y0
    with annotate(SOLVE):
        for i in range(ts.shape[0] - 1):
            t0 = ts[i]
            dt = (ts[i + 1] - t0) / steps_per_interval
            for j in range(steps_per_interval):
                t = t0 + dt * _f32(j)
                y, _ = _rk_step(spanned, tab, t, y, dt, spanned(t, y, args),
                                args)
            ys.append(y)
        return torch.stack(ys)


def _error_norm(tab: Tableau, hk, ks, y0, y1, rtol, atol,
                stats=None) -> torch.Tensor:
    """The controller's scaled RMS error of the step ``y0 → y1``, outside
    autograd: one pass over the state, a 0-d tensor on its device. ``hk``
    as ``_rk_step`` takes it."""
    js, cs = _plan(tab)[3]
    with torch.no_grad():
        return _counted(stats, rk.rk_norm, hk, cs,
                        [ks[j].detach() for j in js], y0.detach(),
                        y1.detach(), rtol, atol)


def _error_ratio(tab: Tableau, h, ks, y0, y1, rtol, atol,
                 stats=None) -> torch.Tensor:
    """``_error_norm`` read home: an eager attempt's one device read."""
    return _error_norm(tab, float(h), ks, y0, y1, rtol, atol, stats).cpu()


def _optimal_dt(dt, ratio, order, safety=0.9, min_factor=0.2,
                max_factor=10.0) -> torch.Tensor:
    if ratio <= 1e-10:  # near-zero error: grow at the maximum rate
        factor = _f32(max_factor)
    else:
        factor = torch.clamp(safety * ratio ** (-1.0 / order), min_factor,
                             max_factor)
    return dt * factor


@torch.no_grad()
def _initial_step_size(rhs, t0, y0, f0, args, order, rtol, atol, stats=None):
    """Hairer-Nørsett-Wanner automatic initial step selection; a constant
    of the solve, so its right-hand-side evaluation records no graph."""
    y0, f0 = y0.detach(), f0.detach()

    def scaled_norm(coeffs, xs):
        return _counted(stats, rk.rk_norm, None, coeffs, xs, y0, None, rtol,
                        atol, False).cpu()

    d0 = scaled_norm((1.0,), (y0,))
    d1 = scaled_norm((1.0,), (f0,))
    if d0 < 1e-5 or d1 < 1e-5:
        h0 = _f32(1e-6)
    else:
        h0 = 0.01 * d0 / torch.clamp(d1, min=1e-30)
    y_h0 = _counted(stats, rk.rk_combine, y0, float(h0), (1.0,), (f0,),
                    False)
    f1 = rhs(t0 + h0, y_h0, args)
    d2 = scaled_norm((1.0, -1.0), (f1, f0)) / h0  # the norm of f1 - f0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = torch.clamp(h0 * 1e-3, min=1e-6)
    else:
        h1 = (0.01 / torch.clamp(torch.maximum(d1, d2), min=1e-30)) ** (
            1.0 / (order + 1.0))
    return torch.minimum(100.0 * h0, h1)


def _hermite_eval(t0, y0, f0, t1, y1, f1, t, stats=None):
    """Cubic Hermite interpolant over ``[t0, t1]`` evaluated at ``t``: one
    combination of the four tensors, summed from the first term."""
    h = t1 - t0
    theta = (t - t0) / h
    th2 = theta * theta
    th3 = th2 * theta
    c_y0 = 2.0 * th3 - 3.0 * th2 + 1.0
    c_f0 = h * (th3 - 2.0 * th2 + theta)
    c_y1 = -2.0 * th3 + 3.0 * th2
    c_f1 = h * (th3 - th2)
    return _counted(stats, rk.combination, None, None,
                    (float(c_y0), float(c_f0), float(c_y1), float(c_f1)),
                    (y0, f0, y1, f1), False)


# the captured attempts of a declared module (a new key replaces them and
# their memory pools); kept outside the module, so that copying or saving a
# model copies no graph
_ATTEMPTS = weakref.WeakKeyDictionary()


def attempt_graph(rhs, tab: Tableau, y, f, h, rtol,
                  atol) -> Optional["_Attempts"]:
    """The attempted steps of a solve from ``(y, f)`` with ``f = rhs(t,
    y)`` as replays of captured CUDA graphs (``_Attempts``), or None where
    they run eagerly.

    Taken where ``rhs.autonomous`` names a module ``m`` with ``rhs(t, y,
    args) == m(y)``, the tableau is FSAL (Tsit5, dopri5) and
    ``nn.graphed.capture_key`` admits ``m`` on ``y`` (autograd off, the
    state on the card, no capture in progress, registered parameters): a
    right-hand side that read ``t`` or ``args`` would have them baked into
    the graph, so an undeclared one stays eager. The key: ``capture_key``'s,
    the tableau and the tolerances; the first solve under a key captures
    (``ngpde.dispatch.attempt_capture``; ``h`` is the warm-up's step).
    Counters: ``.captures``, the keys captured; ``.replays`` and
    ``.eager``, the attempts that replayed and those that ran eagerly,
    which the solver counts."""
    module = getattr(rhs, "autonomous", None)
    got = None if module is None or not tab.fsal else capture_key(module, y)
    if got is None:
        return None
    key, graphs = got
    key += (tab, rtol, atol)
    attempts = _ATTEMPTS.get(module)
    if attempts is None or attempts.key != key:
        _ATTEMPTS.pop(module, None)
        with annotate("ngpde.dispatch.attempt_capture"):
            attempts = _Attempts(key, graphs, module, tab, rtol, atol, y, f,
                                 h)
        _ATTEMPTS[module] = attempts
        attempt_graph.captures += attempts.ready
    return attempts if attempts.ready else None


attempt_graph.captures = 0
attempt_graph.replays = 0
attempt_graph.eager = 0


def _attempt(module, tab: Tableau, rtol, atol, hk, out, y, f0):
    """One attempted FSAL step from ``(y, f0)`` with the step size ``hk``
    on the card, as ``attempt_graph`` captures it: the new state and its
    derivative copied into the pair ``out``; returns ``(error norm,
    counts)``, the counts (``nfe``, ``combos``, ``combos_fused``) those an
    eager attempt adds to the solve's."""
    counts = dict(nfe=0, combos=0, combos_fused=0)

    def rhs(t, z, args):
        counts["nfe"] += 1
        return module(z)

    zero = _f32(0)  # the stages' times: the module does not read them
    y1, ks = _rk_step(rhs, tab, zero, y, zero, f0, None, counts, hk)
    norm = _error_norm(tab, hk, ks, y, y1, rtol, atol, counts)
    out[0].copy_(y1)
    out[1].copy_(ks[-1])
    return norm, counts


class _Attempts:
    """A solve's attempts as replays of three captured graphs over three
    state pairs ``(y, f)`` on the card, in a ring: the graph from pair
    ``i`` writes the attempt's new state and derivative into pair ``i +
    1`` (mod 3), and an accepted step makes that pair the current one. So
    no attempt copies a state on the host, and an attempt never writes the
    pair of the step before the current one, which the solver's Hermite
    saves read (with two pairs, a rejected attempt after an accepted one
    would overwrite it, and an interval that ran out of attempts would save
    from the rejected state). The graphs share one memory pool: they run
    one at a time, and each reads only the pairs and its own error norm.
    The step size is a 0-d float64 scalar on the card that every graph
    reads."""

    def __init__(self, key, keep, module, tab, rtol, atol, y, f, h):
        self.key = key
        self.h = torch.full((), float(h), dtype=torch.float64,
                            device=y.device)
        self.pairs = [tuple(torch.empty_like(x, memory_format=torch.
                                             contiguous_format).copy_(x)
                            for x in (y, f)) for _ in range(3)]
        self.calls = []
        for i in range(3):
            call = CapturedCall(key, functools.partial(
                _attempt, module, tab, rtol, atol, self.h,
                self.pairs[(i + 1) % 3]), *self.pairs[i], keep=keep,
                pool=self.calls[0].graph.pool() if self.calls else None)
            if call.graph is None:
                break
            self.calls.append(call)
        self.ready = len(self.calls) == 3
        self.cur = 0

    def start(self, y, f):
        """The solve's first pair, holding ``(y, f)``."""
        self.cur = 0
        for dst, src in zip(self.pairs[0], (y, f)):
            dst.copy_(src)
        return self.pairs[0]

    def replay(self, h, stats: dict):
        """One attempt from the current pair with step ``h``: ``((y1, f1),
        error norm)``, ``(y1, f1)`` the next pair."""
        with annotate("ngpde.dispatch.attempt_graph"):
            # h travels as the fill kernel's argument, queued before the
            # replay that reads it
            self.h.fill_(float(h))
            norm, counts = self.calls[self.cur].replay()
        for name, n in counts.items():
            stats[name] += n
        attempt_graph.replays += 1
        return self.pairs[(self.cur + 1) % 3], norm

    def accept(self):
        self.cur = (self.cur + 1) % 3


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
                     y0, ts, args, interpolate: bool, stats: dict, f0=None):
    """Adaptive solve. ``interpolate=True``: free stepping, saves read off
    the cubic Hermite interpolant of the last accepted step (the JAX
    package's ``hermite``); ``False``: steps clamped to land on each save
    point (``tstop``). ``f0``: ``rhs(ts[0], y0)`` if already evaluated.
    With an ``attempts`` list in ``stats``, each interval's attempted steps
    are appended to it.

    Gradients are NaN, as in the JAX checkpoint adjoint, when its replay
    could not have reproduced the solve: with Hermite saves, more than
    ``chk_steps`` accepted steps or ``max_steps`` attempts over the whole
    span, or a span not reached; with tstop saves, more than ``chk_steps``
    accepted steps in one interval, or an interval not reached."""
    if f0 is None:
        f0 = rhs(ts[0], y0, args)
    with annotate("ngpde.solver.init_step"):
        dt = _initial_step_size(rhs, ts[0], y0, f0, args, tab.order, rtol,
                                atol, stats)
    attempts = attempt_graph(rhs, tab, y0, f0, dt, rtol, atol)
    tp, yp, fp = ts[0], y0, f0
    t, y, f = ts[0], y0, f0
    if attempts is not None:
        y, f = attempts.start(y0, f0)
    ys = [y0]
    overflow = False
    for target in ts[1:]:
        n = accepted = 0
        while t < target and n < max_steps:
            with annotate("ngpde.solver.attempt"):
                h = dt if interpolate else torch.minimum(dt, target - t)
                if attempts is None:
                    y1, ks = _rk_step(rhs, tab, t, y, h, f, args, stats)
                    f1, norm = ks[-1], None
                    attempt_graph.eager += 1
                else:
                    (y1, f1), norm = attempts.replay(h, stats)
                with annotate("ngpde.solver.control"):
                    ratio = (_error_ratio(tab, h, ks, y, y1, rtol, atol,
                                          stats) if norm is None
                             else norm.cpu())
                    dt = _optimal_dt(h, ratio, tab.order)
                stats["steps"] += 1
                if ratio <= 1.0:
                    if not tab.fsal:
                        f1 = rhs(t + h, y1, args)
                    if attempts is not None:
                        attempts.accept()
                    tp, yp, fp = t, y, f
                    t, y, f = t + h, y1, f1
                    stats["accepted"] += 1
                    accepted += 1
                n += 1
        if "attempts" in stats:
            stats["attempts"].append(n)
        if interpolate:
            ys.append(_hermite_eval(tp, yp, fp, t, y, f, target, stats))
        else:  # the attempt graphs' pairs are overwritten later
            ys.append(y if attempts is None else y.clone())
            overflow |= accepted > chk_steps or t < target
    if interpolate:
        overflow = (stats["accepted"] > chk_steps
                    or stats["steps"] > max_steps or t < ts[-1])
    out = torch.stack(ys)
    if overflow and out.requires_grad:
        out = _NanGrad.apply(out)
    return out


def _flatten(tree):
    """Leaves of ``tree`` (nested tuples, lists and dicts; anything else is
    a leaf) and a function that rebuilds it from a list of leaves."""
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
    elif isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]
    leaves = [leaf for part, _ in parts for leaf in part]

    def rebuild(new):
        out, off = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[off:off + n]))
            off += n
        if isinstance(tree, dict):
            return dict(zip(tree.keys(), out))
        return type(tree)(out)

    return leaves, rebuild


def _closed_over_leaves(out: torch.Tensor, floor: int, own) -> List:
    """The leaves that require grad in the autograd graph of ``out``, other
    than ``own``, in the order a walk from ``out`` meets them. ``floor`` is
    the sequence number of a node made just before ``out``'s evaluation:
    a node below it is a tensor computed before the evaluation that the
    right-hand side closes over, whose gradient the adjoint cannot route,
    so it raises."""
    found, seen, stack = [], set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        var = getattr(node, "variable", None)
        if var is not None:  # AccumulateGrad: a leaf
            if not any(var is t for t in own + found):
                found.append(var)
            continue
        if node._sequence_nr() < floor:
            raise ValueError(
                "the right-hand side closes over a tensor that requires "
                f"grad and is not a leaf (its graph reaches {node.name()} "
                "from before the solve): pass it through args, or detach "
                "it")
        stack.extend(fn for fn, _ in reversed(node.next_functions))
    return found


@dataclasses.dataclass(eq=False)
class _BacksolveRun:
    """One backsolve solve: what its forward and backward need."""

    rhs: Callable  # counts into ``stats['nfe']``: the forward's
    raw_rhs: Callable
    tab: Tableau
    rtol: float
    atol: float
    max_steps: int
    ts: torch.Tensor
    args: Any
    rebuild: Callable  # args from their leaves
    arg_leaves: list
    diff_pos: List[int]  # positions in arg_leaves of the args that need grad
    interpolate: bool
    stats: dict
    f0: Optional[torch.Tensor]

    def args_with(self, diff_args):
        leaves = list(self.arg_leaves)
        for pos, a in zip(self.diff_pos, diff_args):
            leaves[pos] = a
        return self.rebuild(leaves)

    def forward(self, y0):
        f0, self.f0 = self.f0, None
        return _odeint_adaptive(self.rhs, self.tab, self.rtol, self.atol,
                                self.max_steps, 0, y0, self.ts, self.args,
                                self.interpolate, self.stats, f0=f0)

    def backward(self, ys, g, params):
        """JAX ``_bwd``: for each save interval, last to first, integrate
        ``[y, ȳ, t̄, θ̄]`` from ``s = −t_i`` to ``−t_{i−1}`` (steps clamped
        to the span's end), then add ``g[i−1]`` to ``ȳ``. ``t̄`` carries the
        save times' cotangents: it is not returned (the times are not
        tensors of the caller's), but its entry counts in the error norm
        as JAX's does. Returns ``(ȳ_0, *θ̄)`` for ``params`` (the args that
        need grad, then the closed-over leaves)."""
        n_diff = len(self.diff_pos)
        dev = ys.device
        pieces = [ys[0], ys[0], torch.zeros((), device=dev)] + list(params)
        sizes = [p.numel() for p in pieces]
        dtype = ys.dtype
        for p in pieces:
            dtype = torch.promote_types(dtype, p.dtype)

        def pack(parts):
            return torch.cat([p.reshape(-1).to(dev, dtype) for p in parts])

        def unpack(flat):
            return [piece.reshape(like.shape).to(like.dtype) for piece, like
                    in zip(torch.split(flat, sizes), pieces)]

        def aug_rhs(s, aug, _):
            y, y_bar = unpack(aug)[:2]
            with torch.enable_grad():
                t = (-s).detach().requires_grad_()
                y = y.detach().requires_grad_()
                diff = [params[k].detach().requires_grad_()
                        for k in range(n_diff)]
                dy = rhs(t, y, self.args_with(diff))
                wrt = [y, t] + diff + list(params[n_diff:])
                grads = torch.autograd.grad(dy, wrt, y_bar.to(dy.dtype),
                                            allow_unused=True)
            grads = [torch.zeros_like(w) if gr is None else gr
                     for gr, w in zip(grads, wrt)]
            return pack([-dy.detach(), grads[0], -grads[1]] + grads[2:])

        counts = dict(nfe=0, steps=0, accepted=0, combos=0, combos_fused=0)

        def rhs(t, y, a):
            counts["nfe"] += 1
            with annotate(RHS):
                return self.raw_rhs(t, y, a)

        y_bar = g[-1]
        t_bar = torch.zeros((), device=dev)
        p_bar = [torch.zeros_like(p) for p in params]
        for i in range(len(self.ts) - 1, 0, -1):
            with annotate(SOLVE):
                with torch.no_grad():
                    f_i = rhs(self.ts[i], ys[i], self.args)
                    t_bar = t_bar - torch.sum(g[i] * f_i)
                span = torch.stack([-self.ts[i], -self.ts[i - 1]])
                aug = _odeint_adaptive(
                    aug_rhs, self.tab, self.rtol, self.atol, self.max_steps,
                    0, pack([ys[i], y_bar, t_bar] + p_bar), span, None,
                    interpolate=False, stats=counts)[-1]
            _, y_bar, t_bar, *p_bar = unpack(aug)
            y_bar = y_bar + g[i - 1]
        self.stats.update(backward_nfe=counts["nfe"],
                          backward_steps=counts["steps"],
                          backward_accepted=counts["accepted"])
        return (y_bar, *p_bar)


class _Backsolve(torch.autograd.Function):
    """The solve under autograd: forward outside autograd, the continuous
    adjoint backward (``_BacksolveRun.backward``)."""

    @staticmethod
    def forward(ctx, run: _BacksolveRun, y0, *params):
        ys = run.forward(y0)
        ctx.run = run
        ctx.save_for_backward(ys, *params)
        return ys

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ys, *params = ctx.saved_tensors
        return (None,) + ctx.run.backward(ys, g.contiguous(), params)


def _backsolve(rhs, raw_rhs, tab, rtol, atol, max_steps, y0, ts, args,
               interpolate, stats) -> torch.Tensor:
    """The adaptive solve with the backsolve adjoint (``_Backsolve``), or
    the plain solve when nothing in it requires grad. One recorded
    evaluation of ``rhs`` at ``(ts[0], y0)`` (its value is the solve's
    first) finds the closed-over leaves."""
    arg_leaves, rebuild = _flatten(args)
    diff_pos = [k for k, a in enumerate(arg_leaves)
                if isinstance(a, torch.Tensor) and a.requires_grad]
    diff = [arg_leaves[k].detach().requires_grad_() for k in diff_pos]
    run = _BacksolveRun(rhs, raw_rhs, tab, rtol, atol, max_steps, ts, args,
                        rebuild, arg_leaves, diff_pos, interpolate, stats,
                        None)
    with torch.enable_grad():
        # every autograd node made from here on has a larger sequence number
        probe = torch.zeros((), requires_grad=True) * 1
        floor = probe.grad_fn._sequence_nr()
        y = y0.detach().requires_grad_(y0.requires_grad)
        f0 = rhs(ts[0], y, run.args_with(diff))
    theta = ([] if f0.grad_fn is None
             else _closed_over_leaves(f0, floor, [y] + diff))
    run.f0 = f0.detach()
    if not (y0.requires_grad or diff or theta):
        return run.forward(y0)
    params = [arg_leaves[k] for k in diff_pos] + theta
    return _Backsolve.apply(run, y0, *params)


def odeint(rhs: Callable, y0: torch.Tensor, ts, args=None, *,
           solver="tsit5", rtol: float = 1e-6, atol: float = 1e-6,
           max_steps: int = 10_000, interpolation: str = "hermite",
           adjoint: str = "backsolve", checkpoint_steps: int = 128,
           stats: Optional[dict] = None) -> torch.Tensor:
    """Adaptive solve saving at ``ts`` (``ts[0]`` is the initial time).

    ``interpolation="hermite"``: the controller steps freely and each save
    comes from the cubic Hermite dense output of the step that crosses it.
    ``"tstop"``: steps are clamped to land on every save point.

    Adjoints, as in the JAX package:

    - ``"backsolve"`` (the default): the continuous adjoint, O(1) memory in
      steps. Its gradient is not the discrete solve's exact gradient, and
      since it integrates the state backwards it is exponentially unstable
      when the dynamics are dissipative over long spans (diffusion). The
      right-hand side is differentiated in the tensors of ``args`` that
      require grad and in the leaves it closes over (a module's
      parameters); a closed-over tensor that requires grad but is not a
      leaf raises ``ValueError`` (pass it through ``args``).
    - ``"checkpoint"``: autograd through the accepted steps, equal to the
      JAX package's checkpoint adjoint (the exact discrete gradient);
      ``checkpoint_steps`` bounds accepted steps as its replay buffer does
      (over the whole span for Hermite saves, per interval for tstop), and
      a solve beyond it returns NaN gradients with unchanged values.

    ``stats``, if given, receives ``nfe`` (right-hand-side evaluations),
    ``steps`` (attempted), ``accepted``, ``combos`` (the combinations of
    the state the solver made: stage inputs, error norms, the initial
    step's, Hermite saves) and ``combos_fused`` (those that launched a
    kernel: all of them on the card); a backsolve's backward adds
    ``backward_nfe`` (its right-hand-side evaluations: one per augmented
    evaluation, one per save), ``backward_steps`` and
    ``backward_accepted`` to the same dict.

    A right-hand side with ``rhs.autonomous = m`` declares ``rhs(t, y,
    args) == m(y)`` for a module ``m``: with autograd off and the state on
    the card, each attempted step is then one replay of a captured CUDA
    graph (``attempt_graph``), with the same counts and bits.
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
    counts = {} if stats is None else stats
    counts.update(nfe=0, steps=0, accepted=0, combos=0, combos_fused=0)

    def counted(t, y, a):
        counts["nfe"] += 1
        with annotate(RHS):
            return rhs(t, y, a)

    counted.autonomous = getattr(rhs, "autonomous", None)
    interpolate = interpolation == "hermite"
    with annotate(SOLVE):
        if adjoint == "backsolve" and torch.is_grad_enabled():
            return _backsolve(counted, rhs, tab, rtol, atol, max_steps, y0,
                              _times(ts), args, interpolate, counts)
        return _odeint_adaptive(counted, tab, rtol, atol, max_steps,
                                checkpoint_steps, y0, _times(ts), args,
                                interpolate=interpolate, stats=counts)


@torch.no_grad()
def solve_stats(rhs: Callable, y0: torch.Tensor, ts, args=None, *,
                solver="tsit5", rtol: float = 1e-6, atol: float = 1e-6,
                max_steps: int = 10_000):
    """Diagnostic forward solve with steps clamped to the save points
    (tstop), as the JAX package's: ``(ys, attempts)``, ``attempts`` the
    accepted and rejected steps of each save interval as a ``(T − 1,)``
    int64 tensor (each attempt is a right-hand-side evaluation per
    stage)."""
    tab = get_tableau(solver)
    counts = dict(nfe=0, steps=0, accepted=0, combos=0, combos_fused=0,
                  attempts=[])
    with annotate(SOLVE):
        ys = _odeint_adaptive(rhs, tab, rtol, atol, max_steps, 0, y0,
                              _times(ts), args, interpolate=False,
                              stats=counts)
    return ys, torch.tensor(counts["attempts"], dtype=torch.int64)
