"""VMH continuous-time PDE model (Iakovlev et al., arXiv:2006.08956;
counterpart of ``neuralgraphpde.models.vmh``): ``du/dt = VMHConv(ϕ, γ)(u)``
integrated with an adaptive solver and trained on rollout MSE, with the
graph bound by ``update_graph``."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..graph.gnngraph import GnnGraph
from ..nn.basic import MLP
from ..nn.conv import VMHConv
from ..ode.neural_ode import NeuralGraphODE


def vmh_model(
    state_dim: int = 1,
    pos_dim: int = 2,
    *,
    hidden: int = 60,
    msg_dim: int = 40,
    depth: int = 3,
    tspan: Tuple[float, float] = (0.0, 0.2),
    saveat: Optional[Sequence[float]] = None,
    solver: str = "tsit5",
    rtol: float = 1e-3,
    atol: float = 1e-3,
    initialgraph: Optional[GnnGraph] = None,
    adjoint: str = "checkpoint",
    checkpoint_steps: int = 128,
    max_steps: int = 10_000,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> NeuralGraphODE:
    """ϕ is a tanh MLP ``(2·state + pos) → hidden^depth → msg``; γ is
    ``(state + msg) → hidden^depth → state``. Parameters are drawn from
    ``generator`` on the CPU and placed on ``device``."""
    kw = dict(generator=generator, device=device)
    phi = MLP((2 * state_dim + pos_dim,) + (hidden,) * depth + (msg_dim,),
              activation="tanh", **kw)
    gamma = MLP((state_dim + msg_dim,) + (hidden,) * depth + (state_dim,),
                activation="tanh", **kw)
    conv = VMHConv(phi, gamma, initialgraph=initialgraph)
    return NeuralGraphODE(
        conv, tspan=tspan, solver=solver,
        saveat=tuple(saveat) if saveat is not None else None,
        rtol=rtol, atol=atol, adjoint=adjoint,
        checkpoint_steps=checkpoint_steps, max_steps=max_steps,
        output="all")
