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
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neuralgraphpde.ode import integrate as jax_int  # noqa: E402
from neuralgraphpde.ode.tableaus import TABLEAUS as JAX_TABLEAUS  # noqa
from neuralgraphpde_torch.ode import (TABLEAUS, odeint,  # noqa: E402
                                      odeint_grid)
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
