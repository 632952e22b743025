"""The adaptive and fixed-grid solvers' vector algebra on the state, one pass
over memory per operation (CUDA source: ``neuralgraphpde_torch/csrc/
rk_stage.cu``).

Replaces no Pallas kernel. The JAX reference writes a Runge-Kutta stage
input ``y + h·Σ a_ij k_j``, the error estimate and its scaled RMS norm and
the Hermite interpolant in jnp, and XLA fuses each into one loop over the
state. Eager PyTorch makes each product and sum a kernel of its own, one
pass over device memory each, so on a 67 MB state (the 512² grid at width
64) the algebra took more device time than the right-hand side. These
kernels are bound by bytes (a flop or two per element read); each reads
every input once and writes each output once, in 16-byte vectors.

- ``rk_combine(base, h, coeffs, xs, lead_zero)``:
  ``[base +] [h ·] ([0 +] c0·x0 + c1·x1 + …)``, a stage input
  (``lead_zero``: Python's ``sum``, as the solver's stage sums were), the
  Hermite save (no ``base``, no ``h``, summed from the first term), or
  ``y0 + h0·f0``.
- ``rk_norm(h, coeffs, xs, ref0, ref1, rtol, atol)``: the controller's
  ``sqrt(mean(q²))`` with ``q = e / (atol + rtol·max(|ref0|, |ref1|))`` of
  the combination ``e = [h ·] Σ c_j x_j`` (``ref1`` None: ``|ref0|``), as a
  0-d tensor on the state's device: the caller makes the one host read.
- In both, ``h`` may also be a 0-d float64 tensor on the state's card (a
  device scalar): the kernel reads it there (``rk_combine_dh_kernel``,
  ``rk_norm_dh_kernel``), so that a captured CUDA graph takes a new step
  size on every replay. It rounds as the ``float`` of the same value does,
  so the results are the same bits.
- ``rk_scatter(gs, rows, h, use_h)``: the combinations' backward, several
  outputs from one read of the cotangents ``gs``:
  ``out_p = Σ_m rows[p][m] · ([h ·] g_m)`` over the nonzero coefficients,
  summed left to right.

Each rounds every product and sum on its own in the order of the eager
composition it replaced, so for finite inputs ``rk_combine`` and
``rk_scatter`` give that composition's bits (and the autograd backward's,
for one step alone). ``rk_norm``'s sum of squares is taken in double in a
fixed order, not ``torch.sum``'s: its last bits may differ, a rerun's do
not. f32, bf16 (every intermediate rounded to bf16, as eager's bf16
tensors are) and f64 on the card; CPU tensors take the plain versions
(``combine_plain``, ``norm_plain``, ``scatter_plain``: the eager
compositions), CUDA tensors launch the kernel or raise. Every operand has
the first's dtype and shape; at most ``MAX_TERMS`` inputs and
``MAX_OUTPUTS`` outputs a call.

Under autograd (``combination``, ``StageTape``): a combination alone is a
``_Combine`` whose backward is one ``rk_scatter``; the stages of one RK
step share a ``StageTape``, so that each stage's backward, which autograd
runs after every later stage's, returns the complete cotangent of the one
stage derivative ``k`` no earlier stage reads, and the earliest stage's
backward the step's cotangent of ``y``: each written once (see
``StageTape``).

``rk_combine.launches`` counts the combination and scatter launches,
``rk_combine.backward_launches`` the scatter ones; ``rk_norm.launches``
the norms' (two a norm where its state takes more than one block).
"""
from __future__ import annotations

import ctypes
import functools
import operator
import weakref
from typing import Optional, Sequence

import torch

from . import _build

MAX_TERMS = 8  # inputs of one call (kMaxIn in csrc/rk_stage.cu)
MAX_OUTPUTS = 8  # outputs of one scatter (kMaxOut)
_THREADS = 256  # a block (kThreads)
_BLOCKS_PER_SM = 8  # the grid-stride grid: 2,048 threads an SM
_NORM_VECTORS = 8  # the norm takes one block up to 8 vectors a thread
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_VECTOR = {torch.float32: 4, torch.bfloat16: 8, torch.float64: 2}  # 16 B


# ------------------------------------------------------------ plain versions
def combine_plain(base: Optional[torch.Tensor], h: Optional[float],
                  coeffs: Sequence[float], xs: Sequence[torch.Tensor],
                  lead_zero: bool = True):
    """``[base +] [h ·] ([0 +] c0·x0 + …)``: each product and sum an eager
    op, left to right."""
    terms = (c * x for c, x in zip(coeffs, xs))
    acc = sum(terms) if lead_zero else functools.reduce(operator.add, terms)
    if h is not None:
        acc = h * acc
    return acc if base is None else base + acc


def norm_plain(h: Optional[float], coeffs, xs, ref0: torch.Tensor,
               ref1: Optional[torch.Tensor], rtol: float, atol: float,
               lead_zero: bool = True) -> torch.Tensor:
    """``sqrt(mean(q²))``, ``q`` the combination over its scale."""
    e = combine_plain(None, h, coeffs, xs, lead_zero)
    mag = ref0.abs() if ref1 is None else torch.maximum(ref0.abs(),
                                                        ref1.abs())
    q = e / (atol + rtol * mag)
    return torch.sqrt(torch.sum(q * q) / q.numel())


def scatter_plain(gs: Sequence[torch.Tensor], rows, h: float,
                  use_h: Sequence[bool]) -> list:
    """For each row, ``Σ_m c_m · ([h ·] g_m)`` over its nonzero ``c_m``,
    as autograd's backward of the combinations accumulates it."""
    outs = []
    for row, scaled in zip(rows, use_h):
        terms = []
        for c, g in zip(row, gs):
            if c != 0:
                x = g * h if scaled else g
                terms.append(x if c == 1.0 else x * c)
        outs.append(functools.reduce(operator.add, terms))
    return outs


# ------------------------------------------------------------------ launches
@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _operands(like: torch.Tensor, tensors):
    """A CUDA call's operands: on ``like``'s device, of its dtype and
    shape, contiguous."""
    if like.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {like.device}")
    if like.dtype not in _DTYPE_CODES:
        raise TypeError(f"the RK kernels take f32, bf16 or f64, got "
                        f"{like.dtype}")
    out = []
    for t in tensors:
        if t.device != like.device or t.dtype != like.dtype:
            raise TypeError(f"operand on {t.device} in {t.dtype}, expected "
                            f"{like.device} in {like.dtype}")
        if t.shape != like.shape:
            raise ValueError(f"operand of shape {tuple(t.shape)}, expected "
                             f"{tuple(like.shape)}")
        out.append(t.contiguous())
    return out


def _vec(tensors, dtype: torch.dtype) -> int:
    """16-byte vectors where every pointer is 16-byte aligned, else 1."""
    if any(t.data_ptr() % 16 for t in tensors):
        return 1
    return _VECTOR[dtype]


def _grid(numel: int, vec: int, device, per_thread: int = 1) -> int:
    vectors = -(-numel // vec)
    blocks = -(-vectors // (_THREADS * per_thread))
    return max(1, min(blocks, _sm_count(device.index) * _BLOCKS_PER_SM))


def _ptrs(tensors):
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


def _doubles(values):
    return (ctypes.c_double * max(len(values), 1))(*map(float, values))


def _check_terms(n: int, most: int, what: str) -> None:
    if n > most:
        raise ValueError(f"{what} takes at most {most}, got {n}")


def _device_h(h, like: torch.Tensor) -> bool:
    """Whether ``h`` is a device scalar (module docstring), checked
    against the state ``like``."""
    if not isinstance(h, torch.Tensor):
        return False
    if h.shape != () or h.dtype != torch.float64 or h.device != like.device:
        raise TypeError(f"a step size on the card is a 0-d float64 tensor "
                        f"on {like.device}, got {tuple(h.shape)} "
                        f"{h.dtype} on {h.device}")
    return True


def _host_h(h):
    """``h`` for a plain version: a CPU device scalar as its ``float``."""
    return float(h) if isinstance(h, torch.Tensor) else h


def rk_combine(base: Optional[torch.Tensor], h,
               coeffs: Sequence[float], xs: Sequence[torch.Tensor],
               lead_zero: bool = True) -> torch.Tensor:
    """``[base +] [h ·] ([0 +] c0·x0 + c1·x1 + …)`` (module docstring), in
    one pass on the card; ``h`` None, a float or a device scalar."""
    if not xs and (base is None or not lead_zero):
        raise ValueError("a combination needs a term (or a base and 0)")
    like = base if base is not None else xs[0]
    if like.device.type == "cpu":
        return combine_plain(base, _host_h(h), coeffs, xs, lead_zero)
    _check_terms(len(xs), MAX_TERMS, "a combination's terms")
    ops = _operands(like, list(xs) + ([] if base is None else [base]))
    terms = ops[:len(xs)]
    out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    vec = _vec(ops + [out], like.dtype)
    numel = out.numel()
    head = (_ptrs(terms), _doubles(coeffs), len(terms),
            None if base is None else ops[-1].data_ptr())
    tail = (int(lead_zero), out.data_ptr(), numel, _DTYPE_CODES[like.dtype],
            vec, _grid(numel, vec, like.device),
            torch.cuda.current_stream(like.device).cuda_stream)
    lib = _build.library()
    if _device_h(h, like):
        err = lib.ngpde_rk_combine_dh(*head, h.data_ptr(), *tail)
    else:
        err = lib.ngpde_rk_combine(*head, 0.0 if h is None else float(h),
                                   int(h is not None), *tail)
    _build.check(err, "rk_combine")
    rk_combine.launches += 1
    return out


def rk_norm(h, coeffs: Sequence[float],
            xs: Sequence[torch.Tensor], ref0: torch.Tensor,
            ref1: Optional[torch.Tensor], rtol: float, atol: float,
            lead_zero: bool = True) -> torch.Tensor:
    """The scaled RMS norm of ``[h ·] Σ c_j x_j`` (module docstring), a 0-d
    tensor on the state's device; outside autograd. ``h`` None, a float or
    a device scalar."""
    if ref0.device.type == "cpu":
        return norm_plain(_host_h(h), coeffs, xs, ref0, ref1, rtol, atol,
                          lead_zero)
    if not xs:
        raise ValueError("a norm needs a term")
    _check_terms(len(xs), MAX_TERMS, "a norm's terms")
    refs = [ref0] + ([] if ref1 is None else [ref1])
    ops = _operands(ref0, list(xs) + refs)
    terms = ops[:len(xs)]
    numel = ref0.numel()
    vec = _vec(ops, ref0.dtype)
    grid = _grid(numel, vec, ref0.device, _NORM_VECTORS)
    partial = torch.empty(grid, dtype=torch.float64, device=ref0.device)
    out = torch.empty((), dtype=ref0.dtype, device=ref0.device)
    head = (_ptrs(terms), _doubles(coeffs), len(terms))
    tail = (int(lead_zero), ops[len(xs)].data_ptr(),
            None if ref1 is None else ops[len(xs) + 1].data_ptr(),
            float(atol), float(rtol), partial.data_ptr(), out.data_ptr(),
            numel, _DTYPE_CODES[ref0.dtype], vec, grid,
            torch.cuda.current_stream(ref0.device).cuda_stream)
    lib = _build.library()
    if _device_h(h, ref0):
        err = lib.ngpde_rk_norm_dh(*head, h.data_ptr(), *tail)
    else:
        err = lib.ngpde_rk_norm(*head, 0.0 if h is None else float(h),
                                int(h is not None), *tail)
    _build.check(err, "rk_norm")
    rk_norm.launches += 1 + (grid > 1)  # the partial sums, then their sum
    return out


def rk_scatter(gs: Sequence[torch.Tensor], rows, h: float,
               use_h: Sequence[bool]) -> list:
    """``[Σ_m rows[p][m] · ([h ·] g_m) for each row p]`` (module
    docstring), one read of ``gs`` on the card; every row has a nonzero
    coefficient."""
    if gs[0].device.type == "cpu":
        return scatter_plain(gs, rows, h, use_h)
    _check_terms(len(gs), MAX_TERMS, "a scatter's inputs")
    _check_terms(len(rows), MAX_OUTPUTS, "a scatter's outputs")
    like = gs[0]
    ops = _operands(like, gs)
    outs = [torch.empty(like.shape, dtype=like.dtype, device=like.device)
            for _ in rows]
    vec = _vec(ops + outs, like.dtype)
    numel = like.numel()
    flat = [float(c) for row in rows for c in row]
    err = _build.library().ngpde_rk_scatter(
        _ptrs(ops), len(ops), _ptrs(outs), _doubles(flat),
        (ctypes.c_int * len(rows))(*map(int, use_h)), len(rows), float(h),
        numel, _DTYPE_CODES[like.dtype], vec, _grid(numel, vec, like.device),
        torch.cuda.current_stream(like.device).cuda_stream)
    _build.check(err, "rk_scatter")
    rk_combine.launches += 1
    rk_combine.backward_launches += 1
    return outs


rk_combine.launches = 0
rk_combine.backward_launches = 0
rk_norm.launches = 0


# ---------------------------------------------------------------- autograd
def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Combine(torch.autograd.Function):
    """One combination under autograd: ``base`` gets the cotangent ``g``,
    each ``x_j`` gets ``c_j · ([h ·] g)``, all from one ``rk_scatter``."""

    @staticmethod
    def forward(ctx, h, coeffs, lead_zero, base, *xs):
        ctx.h, ctx.coeffs = h, coeffs
        return rk_combine(base, h, coeffs, xs, lead_zero)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad[4:]
        take = [k for k, (c, n) in enumerate(zip(ctx.coeffs, need))
                if n and c != 0]
        grads = [None] * len(need)
        if take:
            scaled = ctx.h is not None
            outs = rk_scatter([g], [[ctx.coeffs[k]] for k in take],
                              ctx.h if scaled else 1.0, [scaled] * len(take))
            for k, d in zip(take, outs):
                grads[k] = d
        d_base = g if ctx.needs_input_grad[3] else None
        return (None, None, None, d_base, *grads)


def combination(base: Optional[torch.Tensor], h: Optional[float],
                coeffs: Sequence[float], xs: Sequence[torch.Tensor],
                lead_zero: bool = True) -> torch.Tensor:
    """``rk_combine``, differentiable in ``base`` and ``xs``."""
    if _needs_grad([base, *xs]):
        return _Combine.apply(h, tuple(coeffs), lead_zero, base, *xs)
    return rk_combine(base, h, coeffs, xs, lead_zero)


def _will_run(ref) -> bool:
    """Whether the running backward pass will execute the node ``ref``
    refers to."""
    node = ref()
    return node is not None and torch._C._will_engine_execute_node(node)


class StageTape:
    """The stages of one RK step under autograd.

    Stage ``m``'s input is ``z_m = y + h·Σ_j a_mj k_j`` over its nonzero
    coefficients, and ``k_m = f(z_m)``; so ``k_j``'s cotangent is
    ``h·Σ_{m>j} a_mj g_m`` (``g_m`` that of ``z_m``) and ``y``'s is
    ``Σ_m g_m``. Autograd runs a stage's backward only after ``f(z_m)``'s,
    which waits for every later stage's: so when stage ``m``'s backward
    runs, every later stage that runs has run, and the tape holds its
    ``g``. Stage ``m`` then returns the complete cotangent of each ``k_j``
    that no earlier stage still to run reads (``k_{m-1}``, and more where
    ``f`` ignores its state and earlier stages never run), and the stage
    that runs last returns ``y``'s, each summed as autograd would have
    summed the terms, from the latest stage down, in one ``rk_scatter``;
    every other input gets None. Which stages the pass will still run it
    asks autograd's engine. Contributions from outside the step (the next
    step, a Hermite save) are summed by autograd as before. The tape holds
    the nodes weakly and each ``g`` only until the step's backward ends,
    so a rejected step's stages are freed with it."""

    __slots__ = ("h", "rows", "nodes", "g")

    def __init__(self, h: float):
        self.h = h
        self.rows = {}  # stage -> {k index: its nonzero coefficient}
        self.nodes = {}  # stage -> weak reference to its autograd node
        self.g = {}  # stage -> its input's cotangent, during the backward

    def stage(self, m: int, y: torch.Tensor, js: Sequence[int],
              coeffs: Sequence[float], ks: Sequence[torch.Tensor]):
        """``y + h·Σ coeffs[i]·ks[i]``, ``ks[i]`` being ``k_{js[i]}``."""
        if not _needs_grad([y, *ks]):
            return rk_combine(y, self.h, coeffs, ks)
        self.rows[m] = dict(zip(js, coeffs))
        z = _Stage.apply(self, m, y, *ks)
        self.nodes[m] = weakref.ref(z.grad_fn)
        return z

    def backward(self, m: int, g: torch.Tensor, needs) -> tuple:
        """Stage ``m``'s cotangents for ``(y, *its ks)``."""
        self.g[m] = g
        below = [i for i, ref in self.nodes.items()
                 if i < m and _will_run(ref)]
        ran = sorted(self.g, reverse=True)
        rows, use_h, slots = [], [], []
        for pos, j in enumerate(self.rows[m]):
            if needs[1 + pos] and not any(i > j for i in below):
                rows.append([self.rows[r].get(j, 0.0) for r in ran])
                use_h.append(True)
                slots.append(1 + pos)
        if needs[0] and not below:
            rows.append([1.0] * len(ran))
            use_h.append(False)
            slots.append(0)
        grads = [None] * len(needs)
        if rows:
            outs = rk_scatter([self.g[r] for r in ran], rows, self.h, use_h)
            for slot, d in zip(slots, outs):
                grads[slot] = d
        if not below:
            self.g.clear()
        return tuple(grads)


class _Stage(torch.autograd.Function):
    """A stage input of a ``StageTape``'s step under autograd."""

    @staticmethod
    def forward(ctx, tape, m, y, *ks):
        ctx.tape, ctx.m = tape, m
        return rk_combine(y, tape.h, tuple(tape.rows[m].values()), ks)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (None, None) + ctx.tape.backward(ctx.m, g,
                                                ctx.needs_input_grad[2:])
