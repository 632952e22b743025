"""GNO graph kernel network training on Darcy flow (BASELINE config 4;
counterpart of ``examples/train_gno_darcy.py``): a radius graph over the
grid, ``GNOModel`` (width 64, kernel MLP 6→128→128→4096, 4 layers), Adam at
1e-3 on batches of 4 samples, the mean over a batch of each sample's MSE.

    python -m neuralgraphpde_torch.examples.train_gno_darcy --device cuda
    python -m neuralgraphpde_torch.examples.train_gno_darcy --device cpu \\
        --samples 4 --n 8 --epochs 5

The data are scaled as in the JAX script (``a / max|a|``, ``u / max|u|``),
the first three quarters of the samples train and the rest test, and each
epoch's batches follow ``np.random.default_rng(seed).permutation``. On the
card every ``GNOConv`` runs the GNO kernel (K5) forward, and its backward
kernel in the backward pass. ``--device cuda`` without a card raises;
nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..data.pde import darcy_dataset
from ..models.gno import GNOModel
from ..ops.spmm import precompute
from ..train.loop import MetricsLogger, make_train_step
from ..train.losses import mse
from ..train.optim import adam
from ..utils.state import update_graph

BATCH = 4  # samples per Adam step


@dataclasses.dataclass
class Config:
    num_samples: int = 32
    n: int = 32  # grid resolution (n² nodes)
    radius: float = 0.08
    width: int = 64
    ker_width: int = 128
    depth: int = 4
    lr: float = 1e-3
    epochs: int = 50
    seed: int = 0
    log_path: str = ""

    @property
    def n_train(self) -> int:
        return max(self.num_samples * 3 // 4, 1)


def setup(cfg: Config, device) -> Tuple[GNOModel, torch.Tensor,
                                        torch.Tensor]:
    """The dataset (from ``cfg.seed``), scaled; the model with parameters
    drawn from ``torch.Generator().manual_seed(cfg.seed)`` and the
    precomputed radius graph bound to it. Returns ``(model, a, u)``, both
    ``(samples, n², 1)`` on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    # keep the radius graph connected at coarse resolutions
    radius = max(cfg.radius, 1.6 / (cfg.n + 1))
    data = darcy_dataset(num_samples=cfg.num_samples, n=cfg.n, radius=radius,
                         seed=cfg.seed)
    model = GNOModel(a_dim=1, pos_dim=2, width=cfg.width,
                     ker_width=cfg.ker_width, depth=cfg.depth,
                     generator=torch.Generator().manual_seed(cfg.seed),
                     device=device)
    update_graph(model, precompute(data.graph, dense=False).to(device))
    a = torch.from_numpy(data.a) / float(np.abs(data.a).max())
    u = torch.from_numpy(data.u) / float(np.abs(data.u).max())
    return model, a.to(device), u.to(device)


def batch_loss(model: GNOModel, a_b: torch.Tensor,
               u_b: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of each sample's MSE (the JAX script's ``vmap``
    over samples, as a loop)."""
    return torch.stack([mse(model(a_b[i]), u_b[i])
                        for i in range(a_b.shape[0])]).mean()


def train(model: GNOModel, a: torch.Tensor, u: torch.Tensor,
          cfg: Config) -> MetricsLogger:
    """``cfg.epochs`` epochs of Adam over the training samples; logs the
    last batch's loss and the test MSE after the first epoch and every
    fifth."""
    n_train = cfg.n_train
    step = make_train_step(lambda a_b, u_b: batch_loss(model, a_b, u_b),
                           adam(model.parameters(), cfg.lr))
    logger = MetricsLogger(path=cfg.log_path or None)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        perm = torch.from_numpy(rng.permutation(n_train)).to(a.device)
        for i in range(0, n_train, BATCH):
            idx = perm[i:i + BATCH]
            loss, _ = step(a[idx], u[idx])
        if (epoch + 1) % 5 == 0 or epoch == 0:
            test_mse = float("nan")
            if cfg.num_samples > n_train:
                with torch.no_grad():
                    test_mse = float(batch_loss(model, a[n_train:],
                                                u[n_train:]))
            rec = logger.log(epoch + 1, train_mse=loss, test_mse=test_mse)
            print(f"epoch {epoch + 1:3d} | train mse {rec['train_mse']:.5f} "
                  f"| test mse {rec['test_mse']:.5f}", flush=True)
    return logger


def main(cfg: Config, device="cuda") -> MetricsLogger:
    return train(*setup(cfg, device), cfg)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--log-path", type=str, default="")
    args = p.parse_args()
    main(Config(num_samples=args.samples, n=args.n, epochs=args.epochs,
                log_path=args.log_path),
         device=args.device)
