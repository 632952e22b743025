"""VMH neural graph ODE training on 2-D convection-diffusion over scattered
nodes (BASELINE config 2; counterpart of ``examples/train_vmh.py``):
full-batch Rprop on the mean over all simulations of each one's rollout
MSE, one adaptive solve per simulation.

    python -m neuralgraphpde_torch.examples.train_vmh --device cuda
    python -m neuralgraphpde_torch.examples.train_vmh --device cpu \\
        --sims 4 --points 300 --epochs 20 --log-every 1

On the card the VMH right-hand side runs the fused edge-MLP kernel (K3)
forward, and its backward kernel in the backward pass. ``--device cuda``
without a card raises; nothing falls back to the CPU. ``--adjoint
backsolve`` takes the continuous adjoint instead of the checkpoint one (as
the JAX script's flag): the backward integrates the augmented system, and
each of its right-hand-side evaluations runs K3 forward and backward.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Tuple

import torch

from ..data.pde import convection_diffusion_dataset
from ..models.vmh import vmh_model
from ..ode.neural_ode import NeuralGraphODE
from ..ops.spmm import precompute
from ..train.losses import rollout_mse
from ..train.optim import rprop
from ..utils.profiling import annotate
from ..utils.state import update_graph


@dataclasses.dataclass
class Config:
    num_sims: int = 24
    num_points: int = 3000
    t_end: float = 0.2
    num_saves: int = 21
    hidden: int = 60
    msg_dim: int = 40
    depth: int = 3
    # Rprop(1e-6, (0.5, 1.2), (1e-8, 10.0)), full batch: every simulation
    # in every step
    lr: float = 1e-6
    step_max: float = 10.0
    epochs: int = 200
    seed: int = 0
    rtol: float = 1e-5
    atol: float = 1e-3
    adjoint: str = "checkpoint"
    # bounds the accepted steps of one solve; beyond it the gradients are
    # NaN (the JAX checkpoint adjoint's replay buffer)
    checkpoint_steps: int = 128
    max_steps: int = 10_000
    log_every: int = 10


def setup(cfg: Config, device) -> Tuple[NeuralGraphODE, torch.Tensor]:
    """The dataset (from ``cfg.seed``), the model with parameters drawn
    from ``torch.Generator().manual_seed(cfg.seed)``, and the precomputed
    Delaunay graph bound to it. Returns ``(model, u)`` with ``u`` the
    ``(sims, T, M, 1)`` trajectories on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    data = convection_diffusion_dataset(
        num_sims=cfg.num_sims, num_points=cfg.num_points, t_end=cfg.t_end,
        num_saves=cfg.num_saves, seed=cfg.seed)
    saveat = tuple(float(t) for t in data.ts)
    model = vmh_model(1, 2, hidden=cfg.hidden, msg_dim=cfg.msg_dim,
                      depth=cfg.depth, tspan=(saveat[0], saveat[-1]),
                      saveat=saveat, rtol=cfg.rtol, atol=cfg.atol,
                      adjoint=cfg.adjoint,
                      checkpoint_steps=cfg.checkpoint_steps,
                      max_steps=cfg.max_steps,
                      generator=torch.Generator().manual_seed(cfg.seed),
                      device=device)
    # all simulations share one graph: bind it once
    update_graph(model, precompute(data.graph, dense=False).to(device))
    return model, torch.from_numpy(data.u).to(device)


def full_batch_grad(model: NeuralGraphODE,
                    u: torch.Tensor) -> Tuple[torch.Tensor, List[dict]]:
    """Gradient of the mean over simulations of each one's rollout MSE,
    accumulated into the parameters' ``.grad`` (zeroed first): one solve and
    one backward per simulation (each in an ``ngpde.train.backward`` span
    under a profiler). Returns the loss (a 0-d tensor on ``u``'s device)
    and each solve's ``last_stats``."""
    model.zero_grad(set_to_none=True)
    sims = u.shape[0]
    loss = u.new_zeros(())
    stats = []
    for s in range(sims):
        part = rollout_mse(model(u[s, 0]), u[s]) / sims
        with annotate("ngpde.train.backward"):
            part.backward()
        loss += part.detach()
        stats.append(dict(model.last_stats))
    return loss, stats


def train(model: NeuralGraphODE, u: torch.Tensor,
          cfg: Config) -> List[float]:
    """``cfg.epochs`` full-batch Rprop steps on ``model``; returns the loss
    of every epoch, each taken before that epoch's update."""
    opt = rprop(model.parameters(), cfg.lr, step_max=cfg.step_max)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(1, cfg.epochs + 1):
        loss, stats = full_batch_grad(model, u)
        opt.step()
        losses.append(float(loss))  # device sync
        if epoch % cfg.log_every == 0 or epoch == cfg.epochs:
            accepted = sum(st["accepted"] for st in stats) / len(stats)
            nfe = sum(st["nfe"] for st in stats) / len(stats)
            print(f"epoch {epoch:4d} | train mse {losses[-1]:.5f} | "
                  f"accepted steps/sim {accepted:.1f} | rhs evals/sim "
                  f"{nfe:.1f} | {time.perf_counter() - t0:.1f}s",
                  flush=True)
    return losses


def main(cfg: Config, device="cuda") -> List[float]:
    return train(*setup(cfg, device), cfg)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--sims", type=int, default=24)
    p.add_argument("--points", type=int, default=3000)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--adjoint", default="checkpoint",
                   choices=("checkpoint", "backsolve"))
    p.add_argument("--ckpt-steps", type=int, default=128)
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-3)
    p.add_argument("--max-steps", type=int, default=10_000)
    return p.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(num_sims=args.sims, num_points=args.points,
                  epochs=args.epochs, log_every=args.log_every,
                  adjoint=args.adjoint, checkpoint_steps=args.ckpt_steps,
                  rtol=args.rtol, atol=args.atol, max_steps=args.max_steps)


if __name__ == "__main__":
    args = parse_args()
    main(config_from_args(args), device=args.device)
