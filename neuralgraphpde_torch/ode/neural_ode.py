"""NeuralGraphODE: a GNN as the right-hand side of ``du/dt = model(u)``
(counterpart of ``neuralgraphpde.ode.neural_ode``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.core import ContainerLayer
from .integrate import odeint, odeint_grid
from .tableaus import get_tableau


class NeuralGraphODE(ContainerLayer):
    """Solve ``du/dt = model(u)`` over ``tspan`` (or the ``saveat`` times).

    Returns the solution stacked on a leading time axis (``output='all'``)
    or the final state (``output='last'``). Adaptive tableaus step with
    error control (``interpolation`` as in ``odeint``); ``adjoint='grid'``
    or a fixed-step tableau takes ``steps_per_interval`` equal steps per
    save interval. Gradients of an adaptive solve are those of the JAX
    package's ``adjoint='checkpoint'`` (the default here, as in JAX), with
    ``checkpoint_steps`` bounding the accepted steps, or of its continuous
    ``adjoint='backsolve'`` (``odeint``); the wrapped model's parameters
    reach the right-hand side as the leaves it closes over. After each call
    ``last_stats`` holds the adaptive solver's counts (``nfe``, ``steps``,
    ``accepted``, ``combos``, ``combos_fused``; after a backsolve's
    backward also ``backward_nfe``, ``backward_steps``,
    ``backward_accepted``). With autograd off and the state on the card,
    each attempted step of an adaptive solve replays one captured CUDA
    graph (``ode.integrate.attempt_graph``).
    """

    layer_names = ("model",)

    def __init__(self, model: nn.Module, *,
                 tspan: Tuple[float, float] = (0.0, 1.0),
                 solver: str = "tsit5",
                 saveat: Optional[Tuple[float, ...]] = None,
                 rtol: float = 1e-6, atol: float = 1e-6,
                 max_steps: int = 10_000, adjoint: str = "checkpoint",
                 interpolation: str = "hermite",
                 steps_per_interval: int = 8, checkpoint_steps: int = 128,
                 output: str = "all"):
        super().__init__()
        self.model = model
        self.tspan, self.saveat = tspan, saveat
        self.solver, self.rtol, self.atol = solver, rtol, atol
        self.max_steps, self.adjoint = max_steps, adjoint
        self.interpolation = interpolation
        self.steps_per_interval = steps_per_interval
        self.checkpoint_steps = checkpoint_steps
        self.output = output
        self.last_stats: dict = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def rhs(t, u, args):
            return self.model(u)

        # reads neither t nor args: a solve may capture its attempts
        rhs.autonomous = self.model
        ts = self.saveat if self.saveat is not None else self.tspan
        if self.adjoint == "grid" or not get_tableau(self.solver).adaptive:
            ys = odeint_grid(rhs, x, ts, solver=self.solver,
                             steps_per_interval=self.steps_per_interval)
        else:
            self.last_stats = {}
            ys = odeint(rhs, x, ts, solver=self.solver, rtol=self.rtol,
                        atol=self.atol, max_steps=self.max_steps,
                        interpolation=self.interpolation,
                        adjoint=self.adjoint,
                        checkpoint_steps=self.checkpoint_steps,
                        stats=self.last_stats)
        return ys[-1] if self.output == "last" else ys
