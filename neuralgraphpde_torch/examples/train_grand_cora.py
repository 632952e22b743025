"""GRAND-style graph neural diffusion on a Cora-shaped citation graph
(BASELINE config 1; counterpart of ``examples/train_grand_cora.py``):
dopri5 at rtol = atol = 1e-3, full-batch Adam at 1e-2 on the masked
cross-entropy of the training nodes, train and validation accuracy printed
after the first epoch and every tenth.

    python -m neuralgraphpde_torch.examples.train_grand_cora --device cuda
    python -m neuralgraphpde_torch.examples.train_grand_cora --device cpu \\
        --nodes 300 --features 64 --epochs 3

As in the JAX script, the graph is ``precompute(add_self_loops(graph))``:
at Cora's size that is the dense adjacency, a matrix product and no
kernel. ``setup(cfg, device, dense=False, pallas=True)`` puts the same model
on the segment-SpMM kernel (K1), forward and backward. ``--data-path``
reads the LINQS Cora files; without it the data are synthetic.
``--device cuda`` without a card raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

import torch

from ..data.loaders import cora_dataset
from ..graph.transforms import add_self_loops
from ..models.grand import grand_model
from ..nn.basic import Chain
from ..ops.spmm import precompute
from ..train.loop import MetricsLogger, make_train_step
from ..train.losses import accuracy, masked_cross_entropy
from ..train.optim import adam
from ..utils.state import update_graph


@dataclasses.dataclass
class Config:
    num_nodes: int = 2708
    num_edges: int = 10556
    num_features: int = 1433
    num_classes: int = 7
    hidden: int = 64
    tspan_end: float = 1.0
    solver: str = "dopri5"
    rtol: float = 1e-3
    atol: float = 1e-3
    lr: float = 1e-2
    epochs: int = 100
    seed: int = 0
    data_path: str = ""  # LINQS cora.content/cora.cites dir; synthetic if empty


def setup(cfg: Config, device, **precompute_kw) -> Tuple[Chain, tuple]:
    """The data (files, or synthetic from ``cfg.seed``), the graph as
    ``precompute(add_self_loops(graph), **precompute_kw)``, and the model
    with parameters drawn from ``torch.Generator().manual_seed(cfg.seed)``.
    Returns ``(model, (x, labels, train_mask, val_mask))`` on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device")
    data = cora_dataset(cfg.data_path or None, num_nodes=cfg.num_nodes,
                        num_edges=cfg.num_edges,
                        num_features=cfg.num_features,
                        num_classes=cfg.num_classes, seed=cfg.seed)
    if cfg.data_path:
        cfg.num_features = data.features.shape[1]
        cfg.num_classes = data.num_classes
    g = precompute(add_self_loops(data.graph), **precompute_kw)
    model = grand_model(cfg.num_features, cfg.hidden, cfg.num_classes,
                        tspan=(0.0, cfg.tspan_end), solver=cfg.solver,
                        rtol=cfg.rtol, atol=cfg.atol,
                        precomputed_self_loops=True,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        device=device)
    update_graph(model, g.to(device))
    tensors = tuple(torch.from_numpy(a).to(device) for a in (
        data.features, data.labels, data.train_mask, data.val_mask))
    return model, tensors


def train(model: Chain, tensors: tuple, cfg: Config) -> MetricsLogger:
    """``cfg.epochs`` full-batch Adam steps; logs the loss and the train and
    validation accuracy after the first and every tenth, as the JAX script
    does."""
    x, y, train_m, val_m = tensors
    step = make_train_step(
        lambda: masked_cross_entropy(model(x), y, train_m),
        adam(model.parameters(), cfg.lr))
    logger = MetricsLogger()
    for epoch in range(cfg.epochs):
        loss, _ = step()
        if (epoch + 1) % 10 == 0 or epoch == 0:
            with torch.no_grad():
                logits = model(x)
            rec = logger.log(epoch + 1, loss=loss,
                             train_acc=accuracy(logits, y, train_m),
                             val_acc=accuracy(logits, y, val_m))
            print(f"epoch {epoch + 1:4d} | loss {rec['loss']:.4f} | "
                  f"train acc {rec['train_acc']:.3f} | "
                  f"val acc {rec['val_acc']:.3f}", flush=True)
    return logger


def main(cfg: Config, device="cuda") -> MetricsLogger:
    model, tensors = setup(cfg, device)
    return train(model, tensors, cfg)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--nodes", type=int, default=2708)
    p.add_argument("--features", type=int, default=1433)
    p.add_argument("--data-path", default="",
                   help="directory with cora.content/cora.cites (real data)")
    args = p.parse_args()
    main(Config(epochs=args.epochs, num_nodes=args.nodes,
                num_edges=args.nodes * 4, num_features=args.features,
                data_path=args.data_path),
         device=args.device)
