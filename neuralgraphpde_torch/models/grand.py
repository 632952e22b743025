"""GRAND-style neural graph diffusion for node classification (counterpart
of ``neuralgraphpde.models.grand``): an encoder GCN, a GCN-chain ODE
right-hand side integrated over ``tspan``, and a linear decoder."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..graph.gnngraph import GnnGraph
from ..nn.basic import Chain, Dense
from ..nn.conv import GCNConv
from ..ode.neural_ode import NeuralGraphODE


def grand_model(
    in_dims: int,
    hidden_dims: int,
    out_dims: int,
    *,
    tspan: Tuple[float, float] = (0.0, 1.0),
    solver: str = "tsit5",
    rtol: float = 1e-3,
    atol: float = 1e-3,
    adjoint: str = "checkpoint",
    steps_per_interval: int = 8,
    initialgraph: Optional[GnnGraph] = None,
    rhs_depth: int = 2,
    precomputed_self_loops: bool = False,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Chain:
    """``Chain(GCNConv(in→h, relu), NeuralGraphODE(Chain(GCNConv(h→h,
    tanh) × rhs_depth)), Dense(h→out))``.

    ``precomputed_self_loops=True`` assumes the bound graph already has
    self-loops (``precompute(g, add_self_loops=True)``), so the SpMM cache
    stays valid inside the ODE loop. Parameters are drawn from
    ``generator`` on the CPU and placed on ``device``.
    """
    asl = not precomputed_self_loops
    kw = dict(generator=generator, device=device)
    encoder = GCNConv(in_dims, hidden_dims, "relu", initialgraph,
                      add_self_loops=asl, **kw)
    rhs = Chain(GCNConv(hidden_dims, hidden_dims, "tanh", initialgraph,
                        add_self_loops=asl, **kw)
                for _ in range(rhs_depth))
    node = NeuralGraphODE(
        rhs, tspan=tspan, solver=solver, rtol=rtol, atol=atol,
        adjoint=adjoint, steps_per_interval=steps_per_interval, output="last")
    return Chain((encoder, node, Dense(hidden_dims, out_dims, **kw)))
