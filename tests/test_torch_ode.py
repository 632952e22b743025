"""ODE layer of the port against the JAX package: tableaus, fixed-grid
``odeint_grid`` and adaptive ``odeint`` (Hermite and tstop saves) on the same
right-hand side ``f(y) = 0.1 (tanh(y A) − 0.3 y)``. The host controller
keeps t, dt and the error ratio in f32 as JAX does. Tolerance rtol 2e-5 /
atol 1e-5 where both take the same steps (sums in another order): the fixed
grid, and tstop saves, whose solve attempts exactly as many steps as JAX's
``solve_stats`` counts.

Free (Hermite) stepping is held to 1e-3, ten times the solver's rtol. While
the controller grows dt from the Hairer initial step, the error ratios are
1e-6–1e-4: f32 rounding in the error estimate (different in any two
implementations, the JAX package's own xla and Pallas paths included) then
moves the next step size by a few percent, and two correct solutions differ
by up to the solver tolerance. The interpolant itself is checked tightly.

Gradients are held against the JAX package's ``adjoint="checkpoint"`` at
solver rtol = atol = 1e-5, where both take the same steps: max |port − JAX|
over max |JAX| ≤ 1e-4 (the adjoint replays the steps and sums in another
order than autograd through the loop).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and many small ops gain nothing from more threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neuralgraphpde.ode import integrate as jax_int  # noqa: E402
from neuralgraphpde.ode.tableaus import TABLEAUS as JAX_TABLEAUS  # noqa
from neuralgraphpde_torch.ode import (TABLEAUS, odeint,  # noqa: E402
                                      odeint_grid)
from neuralgraphpde_torch.ode import integrate as port_int  # noqa: E402
from neuralgraphpde_torch.ode.integrate import _hermite_eval  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-5)
TS = [0.0, 3.0, 7.0, 15.0]


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(6, 6)) / 2).astype(np.float32)
    y0 = rng.normal(size=(20, 6)).astype(np.float32)
    aj, ap = jnp.asarray(a), torch.from_numpy(a)
    jax_rhs = lambda t, y, args: 0.1 * (jnp.tanh(y @ aj) - 0.3 * y)  # noqa
    port_rhs = lambda t, y, args: 0.1 * (torch.tanh(y @ ap) - 0.3 * y)  # noqa
    return y0, jax_rhs, port_rhs


def test_tableaus_identical():
    assert sorted(TABLEAUS) == sorted(JAX_TABLEAUS)
    for name, tab in TABLEAUS.items():
        assert dataclasses.asdict(tab) == dataclasses.asdict(
            JAX_TABLEAUS[name])


@pytest.mark.parametrize("solver", ["euler", "midpoint", "heun", "rk4"])
def test_odeint_grid_matches_jax(solver):
    y0, jf, pf = _problem()
    want = jax_int.odeint_grid(jf, jnp.asarray(y0), jnp.asarray(TS),
                               solver=solver, steps_per_interval=3)
    got = odeint_grid(pf, torch.from_numpy(y0), TS, solver=solver,
                      steps_per_interval=3)
    assert got.shape == (len(TS),) + y0.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("solver", ["tsit5", "dopri5"])
@pytest.mark.parametrize("interpolation", ["hermite", "tstop"])
def test_odeint_adaptive_matches_jax(solver, interpolation):
    y0, jf, pf = _problem(1)
    kw = dict(solver=solver, rtol=1e-4, atol=1e-4)
    want = jax_int.odeint(jf, jnp.asarray(y0), jnp.asarray(TS),
                          interpolation=interpolation, **kw)
    stats = {}
    got = odeint(pf, torch.from_numpy(y0), TS, interpolation=interpolation,
                 stats=stats, **kw)
    tol = TOL if interpolation == "tstop" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert stats["accepted"] >= len(TS) - 1
    if interpolation == "tstop":
        _, attempts = jax_int.solve_stats(jf, jnp.asarray(y0),
                                          jnp.asarray(TS), **kw)
        assert stats["steps"] == int(np.sum(np.asarray(attempts)))


def test_hermite_interpolant_matches_jax():
    y0, jf, pf = _problem(2)
    rng = np.random.default_rng(3)
    parts = [rng.normal(size=y0.shape).astype(np.float32) for _ in range(4)]
    t0, t1, t = np.float32(0.4), np.float32(1.7), np.float32(1.1)
    want = jax_int._hermite_eval(t0, *map(jnp.asarray, parts[:2]), t1,
                                 *map(jnp.asarray, parts[2:]), t)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    got = _hermite_eval(f32(t0), *map(torch.from_numpy, parts[:2]), f32(t1),
                        *map(torch.from_numpy, parts[2:]), f32(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_odeint_rejects_fixed_step_solver():
    y0, _, pf = _problem()
    with pytest.raises(ValueError, match="no embedded error"):
        odeint(pf, torch.from_numpy(y0), TS, solver="rk4")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _grad_problem(interpolation, checkpoint_steps=128, seed=1):
    """Loss Σ w·ys of a solve at rtol = atol = 1e-5 and its gradients in
    y0 and the RHS matrix, from both packages: ``(jax, port)`` triples of
    (ys, dy0, dA) as numpy."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(6, 6)) / 2).astype(np.float32)
    y0 = rng.normal(size=(20, 6)).astype(np.float32)
    wt = rng.normal(size=(len(TS), 20, 6)).astype(np.float32)
    kw = dict(rtol=1e-5, atol=1e-5, interpolation=interpolation,
              adjoint="checkpoint", checkpoint_steps=checkpoint_steps)

    def jax_loss(y, A):
        ys = jax_int.odeint(
            lambda t, v, m: 0.1 * (jnp.tanh(v @ m) - 0.3 * v), y,
            jnp.asarray(TS), A, **kw)
        return jnp.sum(ys * wt), ys

    (_, ys_j), (dy_j, da_j) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(y0),
                                                jnp.asarray(a))
    yp = torch.from_numpy(y0).requires_grad_()
    ap = torch.from_numpy(a).requires_grad_()
    ys_p = odeint(lambda t, v, _: 0.1 * (torch.tanh(v @ ap) - 0.3 * v), yp,
                  TS, **kw)
    (ys_p * torch.from_numpy(wt)).sum().backward()
    return ((np.asarray(ys_j), np.asarray(dy_j), np.asarray(da_j)),
            (ys_p.detach().numpy(), yp.grad.numpy(), ap.grad.numpy()))


@pytest.mark.parametrize("interpolation", ["hermite", "tstop"])
def test_odeint_gradients_match_jax_checkpoint_adjoint(interpolation):
    want, got = _grad_problem(interpolation)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert _rel(g, w) <= 1e-4


@pytest.mark.parametrize("interpolation,steps", [("hermite", 4),
                                                 ("tstop", 1)])
def test_odeint_checkpoint_overflow_gives_nan_gradients(interpolation,
                                                       steps):
    """More accepted steps than ``checkpoint_steps`` (over the span for
    Hermite, in one interval for tstop): the values are those of the
    unbounded solve and every gradient is NaN, in both packages."""
    (ys_j, dy_j, da_j), (ys_p, dy_p, da_p) = _grad_problem(interpolation,
                                                           steps)
    _, (ys_free, _, _) = _grad_problem(interpolation)
    np.testing.assert_array_equal(ys_p, ys_free)
    assert _rel(ys_p, ys_j) <= 1e-4
    for g in (dy_j, da_j, dy_p, da_p):
        assert np.isnan(g).all()


def test_odeint_controller_stays_out_of_autograd(monkeypatch):
    """Under grad, the step controller's error ratio, initial step, dt and
    t carry no autograd history (else every rejected step's stages would
    stay alive until the backward)."""
    seen = []

    def spy(name):
        orig = getattr(port_int, name)

        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            seen.append((name, out))
            return out

        monkeypatch.setattr(port_int, name, wrapped)

    for name in ("_error_ratio", "_optimal_dt", "_initial_step_size"):
        spy(name)
    y0, _, _ = _problem(1)
    a = torch.from_numpy(np.eye(6, dtype=np.float32)).requires_grad_()
    stats = {}
    ys = odeint(lambda t, v, _: torch.tanh(v @ a) - 20.0 * v,
                torch.from_numpy(y0), TS, rtol=1e-6, atol=1e-6, stats=stats,
                adjoint="checkpoint")
    assert ys.requires_grad
    assert stats["steps"] > stats["accepted"], "no step was rejected"
    names = {name for name, _ in seen}
    assert names == {"_error_ratio", "_optimal_dt", "_initial_step_size"}
    for name, out in seen:
        assert not out.requires_grad, name
