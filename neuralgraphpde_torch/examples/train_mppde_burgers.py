"""MP-PDE solver training on 1-D Burgers rollouts with temporal bundling and
the pushforward trick (BASELINE config 3; counterpart of
``examples/train_mppde_burgers.py``).

    python -m neuralgraphpde_torch.examples.train_mppde_burgers --device cuda
    python -m neuralgraphpde_torch.examples.train_mppde_burgers --device cpu \\
        --sims 4 --nx 64 --epochs 3

32 simulations on a 256-node periodic chain (2 neighbours each side: 1,024
edges), 101 saves, bundles of K = 25 steps, ``MPPDESolver`` (hidden 128,
depth 6), Adam at 1e-4, 20 epochs. One Adam step takes one simulation: 4
windows at starts drawn by ``np.random.default_rng(seed).choice``, and the
loss is the mean over the windows of ``mse(pred1, w1) + mse(model(pred1
.detach()), w2)`` (the pushforward trick: two steps unrolled, gradient
through the second only from its own call). After training, the first
simulation is rolled out from its first bundle and the RMSE over the
bundles is printed.

The graph is ``precompute(graph, dense=False)``, which attaches the edge-id
layout, so on the card every ``MPPDEConv`` runs the fused edge-MLP kernel
(K3) forward and backward: 4 windows × 2 calls × 6 convs = 48 forward and
48 backward launches per step. ``--device cuda`` without a card raises;
nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..data.pde import burgers_dataset
from ..models.mppde import MPPDESolver
from ..ops.spmm import precompute
from ..train.loop import MetricsLogger, make_train_step
from ..train.losses import mse
from ..train.optim import adam

SAMPLES = 4  # windows of one simulation per Adam step


@dataclasses.dataclass
class Config:
    num_sims: int = 32
    nx: int = 256
    t_end: float = 2.0
    num_saves: int = 101
    bundle: int = 25
    hidden: int = 128
    depth: int = 6
    lr: float = 1e-4
    epochs: int = 20
    pushforward: bool = True
    seed: int = 0
    log_path: str = ""


def setup(cfg: Config, device) -> Tuple[MPPDESolver, torch.Tensor]:
    """The dataset (from ``cfg.seed``, solved on ``device``) and the model
    with parameters drawn from ``torch.Generator().manual_seed(cfg.seed)``
    and the precomputed graph bound to it. Returns ``(model, u)`` with
    ``u`` the ``(sims, nx, T)`` trajectories on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    data = burgers_dataset(num_sims=cfg.num_sims, nx=cfg.nx, t_end=cfg.t_end,
                           num_saves=cfg.num_saves, seed=cfg.seed,
                           device=device)
    if data.u.shape[1] < 3 * cfg.bundle:
        raise ValueError("need at least 3 bundles of snapshots")
    model = MPPDESolver(bundle=cfg.bundle, hidden=cfg.hidden, depth=cfg.depth,
                        pos_dim=1,
                        initialgraph=precompute(data.graph,
                                                dense=False).to(device),
                        generator=torch.Generator().manual_seed(cfg.seed),
                        device=device)
    u = torch.from_numpy(np.ascontiguousarray(
        np.transpose(data.u[..., 0], (0, 2, 1))))
    return model, u.to(device)


def window_starts(cfg: Config, num_times: int) -> np.ndarray:
    """The first step of every window triple ``(w0, w1, w2)``."""
    K = cfg.bundle
    return np.arange(0, num_times - 3 * K + 1, K)


def batch_loss(model: MPPDESolver, u_sim: torch.Tensor, starts,
               pushforward: bool = True) -> torch.Tensor:
    """Mean over the windows starting at ``starts`` of one simulation's
    ``(nx, T)`` trajectory (the JAX script's ``vmap``, as a loop)."""
    K = model.bundle
    losses = []
    for s0 in (int(s) for s in starts):
        w0, w1, w2 = (u_sim[:, s0 + i * K:s0 + (i + 1) * K]
                      for i in range(3))
        pred1 = model(w0)
        loss = mse(pred1, w1)
        if pushforward:
            loss = loss + mse(model(pred1.detach()), w2)
        losses.append(loss)
    return torch.stack(losses).mean()


def rollout_rmse(model: MPPDESolver, u_sim: torch.Tensor) -> Tuple[float,
                                                                   int]:
    """RMSE of the rollout from the first bundle against the trajectory,
    over whole bundles (the first included), and the steps it covers."""
    K, T = model.bundle, u_sim.shape[1]
    w0 = u_sim[:, :K]
    traj = model.rollout(w0, (T - K) // K)
    pred = torch.cat([w0[None], traj], dim=0)
    true = torch.stack([u_sim[:, k * K:(k + 1) * K] for k in range(T // K)])
    n = min(pred.shape[0], true.shape[0])
    return float(torch.sqrt(mse(pred[:n], true[:n]))), n * K


def train(model: MPPDESolver, u: torch.Tensor, cfg: Config) -> MetricsLogger:
    """``cfg.epochs`` epochs, one Adam step per simulation; logs the last
    step's loss every epoch, then prints the first simulation's rollout
    RMSE (logged too with ``cfg.log_path``, as in the JAX script)."""
    starts = window_starts(cfg, u.shape[2])
    step = make_train_step(
        lambda u_sim, s0s: batch_loss(model, u_sim, s0s, cfg.pushforward),
        adam(model.parameters(), cfg.lr))
    logger = MetricsLogger(path=cfg.log_path or None)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        for i in range(cfg.num_sims):
            loss, _ = step(u[i], rng.choice(starts, size=SAMPLES))
        rec = logger.log(epoch + 1, train_mse=loss)
        print(f"epoch {epoch + 1:3d} | bundle mse {rec['train_mse']:.5f}",
              flush=True)
    rmse, steps = rollout_rmse(model, u[0])
    print(f"rollout rmse over {steps} steps: {rmse:.4f}", flush=True)
    if cfg.log_path:
        logger.log(cfg.epochs + 1, rollout_rmse=rmse)
    return logger


def main(cfg: Config, device="cuda") -> MetricsLogger:
    return train(*setup(cfg, device), cfg)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--sims", type=int, default=32)
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--bundle", type=int, default=25)
    p.add_argument("--log-path", type=str, default="")
    args = p.parse_args()
    main(Config(num_sims=args.sims, nx=args.nx, epochs=args.epochs,
                bundle=args.bundle, log_path=args.log_path),
         device=args.device)
