"""The solver's RK stage algebra in one pass per combination
(``kernels/rk_kernels.py``, ``csrc/rk_stage.cu``) against the eager
composition it replaced.

The oracle is the solver's old code, kept here: every stage input as
``y + h·sum(a·k)`` over the whole tableau row, the new state from the ``b``
row, the error estimate and ``_error_ratio``'s eager norm, the Hermite
save and the initial step as eager ops, and their gradients by autograd.
It is put in place of the solver's functions (``eager``) to run a whole
solve the old way.

On the CPU (the plain versions): every combination gives the eager bits
(a term with a zero coefficient, which the new code leaves out, adds ±0
after the leading 0 and changes no finite sum), so whole solves give the
same values and the same steps; one step's gradients give the same bits
(each cotangent is summed in autograd's order); whole solves' gradients
agree to 1e-5 of their largest entry (contributions from outside a step are
added to the step's sum instead of into it, and, with Tsit5 and dopri5, the
new state's cotangent joins the last stage's before it is scaled). Also:
``gradcheck`` in float64, a right-hand side that ignores its state (no
stage backward runs but the last), rejected steps (their tapes are freed
with them), NaN gradients past ``checkpoint_steps``, the backsolve, and the
``combos`` counters.

On a card (``cuda`` marker; skipped without one): each kernel against its
plain version on the card, bit for bit (the norm to 1e-6, and a rerun to
the bit), in f32, bf16 and f64, at odd lengths, misaligned views and the
backsolve's packed 1-D state; one step's gradients against the eager
oracle's bits; a GRAND forward and gradient on a small grid with the same
evaluations as the eager path, every combination fused; the step size read
from the card (a 0-d float64 tensor, as an attempt graph passes it) against
the host's, bit for bit.
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and many small ops gain nothing from more threads
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.kernels import rk_kernels as rk  # noqa: E402
from neuralgraphpde_torch.ode import integrate as port_int  # noqa: E402
from neuralgraphpde_torch.ode.tableaus import get_tableau  # noqa: E402

TS = [0.0, 3.0, 7.0, 15.0]


# ---------------------------------------------------------- the old solver
def _lincomb(coeffs, ks):
    return sum(c * k for c, k in zip(coeffs, ks))


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def eager_rk_step(rhs, tab, t, y, h, f0, args, stats=None):
    hf = float(h)
    ks = [f0]
    for i in range(1, tab.stages):
        incr = _lincomb(tab.a[i], ks[: len(tab.a[i])])
        ks.append(rhs(t + _f32(tab.c[i]) * h, y + hf * incr, args))
    return y + hf * _lincomb(tab.b, ks), ks


def eager_rms(x):
    return torch.sqrt(torch.sum(x * x) / x.numel()).cpu()


def eager_error_ratio(tab, h, ks, y0, y1, rtol, atol, stats=None):
    with torch.no_grad():
        err = float(h) * _lincomb(tab.b_err, [k.detach() for k in ks])
        scale = atol + rtol * torch.maximum(y0.detach().abs(),
                                            y1.detach().abs())
        return eager_rms(err / scale)


@torch.no_grad()
def eager_initial_step_size(rhs, t0, y0, f0, args, order, rtol, atol,
                            stats=None):
    y0, f0 = y0.detach(), f0.detach()

    def scaled_norm(x, ref):
        return eager_rms(x / (atol + rtol * ref.abs()))

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


def eager_hermite_eval(t0, y0, f0, t1, y1, f1, t, stats=None):
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


@pytest.fixture
def eager(monkeypatch):
    """``run(fn)``: ``fn()`` with the solver's old eager functions in
    place."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(port_int, "_rk_step", eager_rk_step)
            m.setattr(port_int, "_error_ratio", eager_error_ratio)
            m.setattr(port_int, "_initial_step_size",
                      eager_initial_step_size)
            m.setattr(port_int, "_hermite_eval", eager_hermite_eval)
            return fn()
    return run


# ---------------------------------------------------------------- helpers
def _problem(seed=0, device="cpu", dtype=torch.float32, n=20, w=6):
    g = torch.Generator().manual_seed(seed)
    a = (torch.randn(w, w, generator=g) / 2).to(device, dtype)
    y0 = torch.randn(n, w, generator=g).to(device, dtype)

    def rhs(t, y, args):
        return 0.1 * (torch.tanh(y @ args) - 0.3 * y)

    return y0, a, rhs


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _states(seed, n, count, device="cpu", dtype=torch.float32):
    """``count`` random states with a few exact zeros of either sign."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(count):
        x = torch.randn(n, generator=g)
        x[::17] = 0.0
        x[5::23] = -0.0
        out.append(x.to(device, dtype))
    return out


# -------------------------------------------------------- CPU: the values
@pytest.mark.parametrize("solver", ["tsit5", "dopri5", "rk4"])
def test_combinations_match_eager_bitwise(solver):
    """Every stage input, the new state (for Tsit5 and dopri5 the last
    stage input itself), the error ratio, the Hermite save and the initial
    step against the eager composition, bit for bit."""
    tab = get_tableau(solver)
    rows, b, reuse, err = port_int._plan(tab)
    assert reuse == (solver != "rk4")
    y, y1, *ks = _states(1, 997, 2 + tab.stages)
    hf = 0.0371
    for i in range(1, tab.stages):
        js, cs = rows[i]
        got = rk.rk_combine(y, hf, cs, [ks[j] for j in js])
        want = y + hf * _lincomb(tab.a[i], ks[: len(tab.a[i])])
        assert torch.equal(got, want), i
    js, cs = b
    new = rk.rk_combine(y, hf, cs, [ks[j] for j in js])
    assert torch.equal(new, y + hf * _lincomb(tab.b, ks))
    if reuse:
        js, cs = rows[-1]
        assert torch.equal(rk.rk_combine(y, hf, cs, [ks[j] for j in js]),
                           new)
    if tab.adaptive:
        got = port_int._error_ratio(tab, _f32(hf), ks, y, y1, 1e-3, 1e-4)
        want = eager_error_ratio(tab, _f32(hf), ks, y, y1, 1e-3, 1e-4)
        assert got.dtype == want.dtype and got.shape == want.shape == ()
        assert torch.equal(got, want)
    ts = [_f32(v) for v in (0.4, 1.7, 1.1)]
    assert torch.equal(
        port_int._hermite_eval(ts[0], y, ks[0], ts[1], y1, ks[1], ts[2]),
        eager_hermite_eval(ts[0], y, ks[0], ts[1], y1, ks[1], ts[2]))
    y0, a, rhs = _problem(2)
    f0 = rhs(0.0, y0, a)
    assert torch.equal(
        port_int._initial_step_size(rhs, _f32(0), y0, f0, a, 5, 1e-3, 1e-3),
        eager_initial_step_size(rhs, _f32(0), y0, f0, a, 5, 1e-3, 1e-3))


def test_scatter_plain_sums_in_autograd_order():
    """``scatter_plain`` for a stage row against autograd through
    ``y + h·sum(a·k)`` over two rows, bit for bit."""
    gs = _states(3, 301, 2)
    rows = [[0.3, -1.7], [1.0, 1.0]]
    got = rk.scatter_plain(gs, rows, 0.25, [True, False])
    k = torch.zeros(301, requires_grad=True)
    y = torch.zeros(301, requires_grad=True)
    z2 = y + 0.25 * _lincomb([0.3], [k])
    z1 = y + 0.25 * _lincomb([-1.7], [k])
    torch.autograd.backward([z2, z1], [gs[0], gs[1]])
    assert torch.equal(got[0], k.grad) and torch.equal(got[1], y.grad)


# --------------------------------------------------------- CPU: gradients
@pytest.mark.parametrize("solver", ["rk4", "tsit5", "dopri5", "midpoint",
                                    "euler"])
def test_one_step_gradients_match_eager_bitwise(solver):
    """One step from a leaf state, its first derivative in the graph: the
    gradients of the state and of the right-hand side's weight are the
    eager autograd's bits."""
    tab = get_tableau(solver)
    y0, a, rhs = _problem(1)
    grads = []
    for step in (port_int._rk_step, eager_rk_step):
        y = y0.clone().requires_grad_()
        w = a.clone().requires_grad_()
        y1, _ = step(rhs, tab, _f32(0), y, _f32(0.3), rhs(0, y, w), w)
        grads.append(torch.autograd.grad((y1 ** 2).sum(), [y, w]))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def _solve_grads(solve, y0, a):
    y = y0.clone().requires_grad_()
    w = a.clone().requires_grad_()
    ys = solve(y, w)
    return (ys.detach(), *torch.autograd.grad((ys ** 2).sum(), [y, w]))


@pytest.mark.parametrize("solver", ["tsit5", "dopri5"])
@pytest.mark.parametrize("interpolation", ["hermite", "tstop"])
def test_solve_gradients_match_eager(eager, solver, interpolation):
    """Checkpoint-adjoint solves (Hermite and tstop saves): the same values
    and steps, gradients to 1e-5 of their largest entry."""
    y0, a, rhs = _problem(0)
    stats = [{}, {}]

    def solve(k):
        return lambda y, w: P.odeint(
            rhs, y, TS, w, solver=solver, rtol=1e-5, atol=1e-5,
            interpolation=interpolation, adjoint="checkpoint",
            stats=stats[k])

    got = _solve_grads(solve(0), y0, a)
    want = eager(lambda: _solve_grads(solve(1), y0, a))
    assert torch.equal(got[0], want[0])
    assert all(stats[0][k] == stats[1][k] for k in ("nfe", "steps",
                                                     "accepted"))
    for g, e in zip(got[1:], want[1:]):
        assert _rel(g, e) <= 1e-5


def test_rejected_steps_match_eager_and_free_their_tapes(eager,
                                                         monkeypatch):
    """A stiff solve that rejects steps: values and gradients as the eager
    path's; the tape of every rejected attempt is freed as soon as the
    next attempt starts (only accepted steps stay alive until the
    backward), and every tape after it."""
    y0, a, _ = _problem(1)
    a = torch.eye(6)
    stats = [{}, {}]

    def rhs(t, v, w):
        return torch.tanh(v @ w) - 20.0 * v

    def solve(k):
        return lambda y, w: P.odeint(rhs, y, [0.0, 0.1, 0.3], w, rtol=1e-6,
                                     atol=1e-6, adjoint="checkpoint",
                                     stats=stats[k])

    tapes = []

    class Spy(rk.StageTape):
        def __init__(self, h):
            super().__init__(h)
            tapes.append(weakref.ref(self))

    monkeypatch.setattr(rk, "StageTape", Spy)
    gc.disable()
    try:
        y = y0.clone().requires_grad_()
        w = a.clone().requires_grad_()
        ys = solve(0)(y, w)
        alive = sum(ref() is not None for ref in tapes)
        assert stats[0]["steps"] > stats[0]["accepted"], "nothing rejected"
        assert alive == stats[0]["accepted"]
        got = (ys.detach(), *torch.autograd.grad((ys ** 2).sum(), [y, w]))
        del ys
        assert all(ref() is None for ref in tapes)
    finally:
        gc.enable()
    want = eager(lambda: _solve_grads(solve(1), y0, a))
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        assert _rel(g, e) <= 1e-5


@pytest.mark.parametrize("interpolation", ["hermite", "tstop"])
def test_checkpoint_overflow_still_gives_nan_gradients(interpolation):
    y0, a, rhs = _problem(0)
    y = y0.clone().requires_grad_()
    ys = P.odeint(rhs, y, TS, a, rtol=1e-5, atol=1e-5, adjoint="checkpoint",
                  interpolation=interpolation, checkpoint_steps=1)
    (g,) = torch.autograd.grad(ys.sum(), [y])
    assert torch.isnan(g).all()


def test_backsolve_matches_eager_bitwise(eager):
    """The continuous adjoint: the forward and the augmented backward solve
    run outside autograd, every combination in the plain versions: the
    eager path's bits."""
    y0, a, rhs = _problem(2)
    stats = [{}, {}]

    def solve(k):
        return lambda y, w: P.odeint(rhs, y, TS, w, rtol=1e-5, atol=1e-5,
                                     adjoint="backsolve", stats=stats[k])

    got = _solve_grads(solve(0), y0, a)
    want = eager(lambda: _solve_grads(solve(1), y0, a))
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert stats[0]["backward_nfe"] == stats[1]["backward_nfe"] > 0


@pytest.mark.parametrize("solver", ["rk4", "euler", "midpoint", "heun"])
def test_grid_solve_matches_eager(eager, solver):
    y0, a, rhs = _problem(3)

    def solve(y, w):
        return P.odeint_grid(rhs, y, [0.0, 1.0, 2.0], w, solver=solver,
                             steps_per_interval=3)

    got = _solve_grads(solve, y0, a)
    want = eager(lambda: _solve_grads(solve, y0, a))
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        assert _rel(g, e) <= 1e-5


def test_gradcheck_float64():
    """``gradcheck`` through steps of fixed size: an rk4 grid solve, and two
    Tsit5 steps with a Hermite save between them."""
    y0, a, rhs = _problem(4, dtype=torch.float64, n=4, w=3)
    y = y0.clone().requires_grad_()
    w = a.clone().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda y, w: P.odeint_grid(rhs, y, [0.0, 0.5, 1.0], w, solver="rk4",
                                   steps_per_interval=2), (y, w))
    tab = get_tableau("tsit5")
    h = _f32(0.25)

    def two_steps(y, w):
        y1, k1 = port_int._rk_step(rhs, tab, _f32(0), y, h, rhs(0, y, w), w)
        y2, k2 = port_int._rk_step(rhs, tab, h, y1, h, k1[-1], w)
        return port_int._hermite_eval(h, y1, k1[-1], 2 * h, y2, k2[-1],
                                      _f32(0.4))

    assert torch.autograd.gradcheck(two_steps, (y, w))


def test_state_free_rhs_gets_its_gradient(eager):
    """``dy/dt = θ cos t`` never reads its state, so autograd runs no stage
    backward but the one whose output is the new state: that one returns
    every derivative's cotangent. ``θ``'s gradient is ``sin t`` at each
    save, as the eager path gives it."""
    theta = torch.tensor([0.5, -1.0, 2.0])

    def grads():
        th = theta.clone().requires_grad_()
        ys = P.odeint(lambda t, v, a: a * torch.cos(t) + 0.0 * v.detach(),
                      torch.zeros(3), [0.0, 1.0, 2.0], th, rtol=1e-6,
                      atol=1e-6, adjoint="checkpoint")
        return torch.autograd.grad(ys[-1].sum(), [th])[0]

    got = grads()
    want = eager(grads)
    assert _rel(got, want) <= 1e-6
    # the solution's own error: the controller holds it to rtol = atol
    # = 1e-6 a step, relative to y(t) = θ sin t
    assert torch.allclose(got, torch.full((3,), float(np.sin(2.0))),
                          atol=1e-3)


def test_combination_counters():
    """``combos``: 4 for the initial step, one per stage input (6 for
    Tsit5; the new state is the last) and one error norm an attempt, one
    Hermite save a save; ``combos_fused`` counts those that launched a
    kernel, none on the CPU."""
    y0, a, rhs = _problem(0)
    stats = {}
    before = (rk.rk_combine.launches, rk.rk_norm.launches)
    P.odeint(rhs, y0, TS, a, rtol=1e-5, atol=1e-5, adjoint="checkpoint",
             stats=stats)
    assert stats["combos"] == 4 + 7 * stats["steps"] + len(TS) - 1
    assert stats["combos_fused"] == 0
    assert (rk.rk_combine.launches, rk.rk_norm.launches) == before
    stats = {}
    P.odeint(rhs, y0, TS, a, solver="dopri5", rtol=1e-5, atol=1e-5,
             interpolation="tstop", stats=stats)
    assert stats["combos"] == 4 + 7 * stats["steps"]


def test_step_size_as_a_scalar_tensor_on_the_cpu():
    """A 0-d float64 step size (an attempt graph's device scalar, here on
    the CPU) gives the ``float``'s bits in both plain versions."""
    xs = _states(3, 257, 5)
    for h in (0.0173, float(_f32(0.3)), 3.7e-6):
        hd = torch.tensor(h, dtype=torch.float64)
        for base, lead in ((xs[-1], True), (None, False)):
            assert torch.equal(rk.rk_combine(base, hd, (0.5, -2.0), xs[:2],
                                             lead),
                               rk.rk_combine(base, h, (0.5, -2.0), xs[:2],
                                             lead))
        args = ((0.1, -0.2, 0.3), xs[:3], xs[3], xs[4], 1e-3, 1e-4)
        assert torch.equal(rk.rk_norm(hd, *args), rk.rk_norm(h, *args))


# ------------------------------------------------------------ CUDA cases
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cases(device, dtype):
    """(label, states of one shape) at odd lengths, a 2-D state, views
    that start 4 bytes into a buffer, and a packed 1-D state of views."""
    big = _states(7, 4099, 9, device, dtype)
    packed = torch.cat([s[:1000] for s in big[:3]])
    return [("odd length 4,099", big),
            ("2-D (257, 64)", [s[:257 * 8].repeat(8).reshape(257, 64)
                               for s in big]),
            ("misaligned views", [s[1:] for s in big]),
            ("length 3", [s[:3] for s in big]),
            ("packed 1-D", [packed] + [torch.split(s, 1000)[0].repeat(3)
                                       for s in big[1:]])]


_DTYPES = [torch.float32, torch.bfloat16, torch.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
def test_rk_combine_kernel_matches_plain_cuda(cuda, dtype):
    before = rk.rk_combine.launches
    for label, xs in _cases(cuda, dtype):
        for n in range(0, rk.MAX_TERMS + 1):
            cs = [0.31 * (-1) ** j * (j + 1) for j in range(n)]
            for base, h, lead in ((xs[-1], 0.0173, True), (None, None, False),
                                  (xs[-1], 0.5, False), (None, 0.25, True)):
                if n == 0 and (base is None or not lead):
                    continue
                got = rk.rk_combine(base, h, cs, xs[:n], lead)
                want = rk.combine_plain(base, h, cs, xs[:n], lead)
                if not isinstance(want, torch.Tensor):
                    continue
                assert got.dtype == want.dtype
                assert torch.equal(got, want), (label, n, h, lead)
    assert rk.rk_combine.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
def test_rk_norm_kernel_matches_plain_cuda(cuda, dtype):
    before = rk.rk_norm.launches
    tol = 1e-6 if dtype != torch.bfloat16 else 1e-2
    for label, xs in _cases(cuda, dtype):
        for refs in ((xs[0], xs[1]), (xs[0], None)):
            args = (0.037, (0.1, -0.2, 0.3), xs[2:5], *refs, 1e-3, 1e-4)
            got = rk.rk_norm(*args)
            want = rk.norm_plain(*args)
            assert got.shape == () and got.dtype == want.dtype
            assert abs(float(got) - float(want)) <= tol * float(want), label
            assert torch.equal(rk.rk_norm(*args), got), label
    big = _states(9, 262144 * 8 + 3, 4, cuda, dtype)
    args = (None, (1.0, -1.0), big[:2], big[2], big[3], 1e-3, 1e-3, False)
    got = rk.rk_norm(*args)
    assert abs(float(got) - float(rk.norm_plain(*args))) <= tol * float(got)
    assert torch.equal(rk.rk_norm(*args), got)
    assert rk.rk_norm.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
def test_device_h_matches_host_h_cuda(cuda, dtype):
    """``rk_combine`` and ``rk_norm`` with the step size read from the card
    (``rk_combine_dh_kernel``, ``rk_norm_dh_kernel``) give the host-h
    kernels' bits; a step size of another dtype or shape raises."""
    before = (rk.rk_combine.launches, rk.rk_norm.launches)
    for label, xs in _cases(cuda, dtype):
        for h in (0.0173, float(_f32(0.3)), 3.7e-6):
            hd = torch.tensor(h, dtype=torch.float64, device=cuda)
            for n in (1, 6, rk.MAX_TERMS):
                cs = [0.31 * (-1) ** j * (j + 1) for j in range(n)]
                for base, lead in ((xs[-1], True), (None, False)):
                    got = rk.rk_combine(base, hd, cs, xs[:n], lead)
                    want = rk.rk_combine(base, h, cs, xs[:n], lead)
                    assert torch.equal(got, want), (label, n, h, lead)
            for refs in ((xs[0], xs[1]), (xs[0], None)):
                args = ((0.1, -0.2, 0.3), xs[2:5], *refs, 1e-3, 1e-4)
                assert torch.equal(rk.rk_norm(hd, *args),
                                   rk.rk_norm(h, *args)), (label, h)
    big = _states(9, 262144 * 8 + 3, 4, cuda, dtype)
    hd = torch.tensor(0.0173, dtype=torch.float64, device=cuda)
    args = ((1.0, -1.0), big[:2], big[2], big[3], 1e-3, 1e-3)
    assert torch.equal(rk.rk_norm(hd, *args), rk.rk_norm(0.0173, *args))
    assert rk.rk_combine.launches > before[0]
    assert rk.rk_norm.launches > before[1]
    for bad in (torch.tensor(0.1, device=cuda),
                torch.tensor([0.1], dtype=torch.float64, device=cuda),
                torch.tensor(0.1, dtype=torch.float64)):
        with pytest.raises(TypeError, match="0-d float64"):
            rk.rk_combine(big[0], bad, (1.0,), big[1:2])
        with pytest.raises(TypeError, match="0-d float64"):
            rk.rk_norm(bad, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES)
def test_rk_scatter_kernel_matches_plain_cuda(cuda, dtype):
    before = rk.rk_combine.backward_launches
    for label, xs in _cases(cuda, dtype):
        gs = xs[:6]
        rows = [[0.5, 0.0, -1.25, 2.0, 0.1, 3.0], [1.0] * 6,
                [0.0, 0.0, 0.0, 0.0, 0.0, 0.7], [-0.3] + [0.0] * 5]
        use_h = [True, False, True, False]
        got = rk.rk_scatter(gs, rows, 0.0371, use_h)
        want = rk.scatter_plain(gs, rows, 0.0371, use_h)
        for p, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (label, p)
    assert rk.rk_combine.backward_launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["rk4", "tsit5", "dopri5"])
def test_one_step_gradients_match_eager_cuda(cuda, solver):
    """One step on the card, kernels forward and backward, against the
    eager composition and its autograd on the card, bit for bit."""
    tab = get_tableau(solver)
    y0, a, rhs = _problem(5, device=cuda, n=4099, w=64)
    results = []
    for step in (port_int._rk_step, eager_rk_step):
        y = y0.clone().requires_grad_()
        w = a.clone().requires_grad_()
        y1, _ = step(rhs, tab, _f32(0), y, _f32(0.3), rhs(0, y, w), w)
        results.append((y1.detach(),
                        *torch.autograd.grad((y1 ** 2).sum(), [y, w])))
    for got, want in zip(*results):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_grand_gradient_fused_cuda(cuda, eager):
    """``grand_model`` on a 48 × 40 grid (fused K2) on the card: the loss,
    the gradients and the evaluations of the eager path, every combination
    of the solve fused, kernels launched forward and backward."""
    g = P.precompute(P.grid_graph_2d(48, 40, diagonals=True),
                     add_self_loops=True, dense=False, pallas=False,
                     bsr=True).to(cuda)
    assert "dia_norm" in g.cache
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(g.num_nodes, 16)).astype(
        np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 3, g.num_nodes)).to(cuda)
    mask = torch.from_numpy(rng.random(g.num_nodes) < 0.2).to(cuda)

    def run():
        model = P.grand_model(16, 16, 3, rtol=1e-5, atol=1e-5,
                              precomputed_self_loops=True,
                              generator=torch.Generator().manual_seed(0),
                              device=cuda)
        P.update_graph(model, g)
        loss = P.masked_cross_entropy(model(x), labels, mask)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.detach(), grads, dict(model.layer_2.last_stats)

    launches = (rk.rk_combine.launches, rk.rk_combine.backward_launches,
                rk.rk_norm.launches)
    loss, grads, stats = run()
    assert rk.rk_combine.launches > launches[0]
    assert rk.rk_combine.backward_launches > launches[1]
    assert rk.rk_norm.launches > launches[2]
    assert stats["combos"] == stats["combos_fused"] > 0
    e_loss, e_grads, e_stats = eager(run)
    assert stats["nfe"] == e_stats["nfe"] and \
        stats["steps"] == e_stats["steps"]
    assert _rel(loss, e_loss) <= 1e-5
    for got, want in zip(grads, e_grads):
        assert _rel(got, want) <= 1e-4

