"""Train the VMH surrogate that the rollout cell serves, with the plain
reference, and write its weights for the benchmark to read.

    python3 bench_torch/train_surrogate.py --out bench_torch/weights/vmh-convdiff.pt

The configuration's full-batch Rprop− (``reference/optim.py``) on the
simulations of ``convdiff-24`` drawn from seed 0, from glorot weights drawn
from the same seed, for the tutorial's 200 epochs. The simulations are
solved in groups of 8 as one graph of disjoint copies of the mesh (one step
size for the group, as the tutorial's loader batches them) by the plain Tsit5 of
``reference/tsit5.py``, the gradient by autograd through the solve and
summed over the groups. Nothing of the port runs. The file holds the
weights and, under ``meta``, how they were made and every epoch's loss.
The benchmark's runs only read it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch.core import cell as cells  # noqa: E402
from bench_torch.core.cell import draw_weights  # noqa: E402
from bench_torch.reference.optim import RpropMinus  # noqa: E402
from bench_torch.reference.tsit5 import solve  # noqa: E402

CONFIG = "vmh-convdiff"
TRAFFIC = "convdiff-24"
SEED = 0  # the simulations, their mesh and the initial weights
EPOCHS = 200  # the tutorial's
GROUP = 8  # simulations solved together


def batched_graph(data: dict, copies: int) -> dict:
    """``copies`` disjoint copies of the mesh as one graph."""
    m = data["num_nodes"]
    off = (np.arange(copies, dtype=np.int64) * m)[:, None]
    return dict(num_nodes=m * copies,
                senders=(data["senders"][None] + off).ravel(),
                receivers=(data["receivers"][None] + off).ravel(),
                pos=np.tile(data["pos"], (copies, 1)))


def train(cfg: dict, ref, data: dict, weights: dict, epochs: int,
          group: int, device, log=print) -> tuple:
    """``epochs`` full-batch Rprop− steps from ``weights``: the trained
    weights (on the host) and each epoch's loss, taken before its
    update."""
    p = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    u = data["u"]  # (sims, T, M, 1)
    sims, steps_t, m = u.shape[0], u.shape[1], u.shape[2]
    groups = [(a, min(a + group, sims)) for a in range(0, sims, group)]
    rhs = {b - a: ref.make_rhs(cfg, batched_graph(data, b - a), p, device)
           for a, b in groups}
    opt = RpropMinus(cfg["lr"], cfg["etas"], cfg["step_sizes"])
    losses = []
    for epoch in range(1, epochs + 1):
        t0 = time.perf_counter()
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total, nfe, accepted = 0.0, 0, 0
        for a, b in groups:
            target = u[a:b].permute(1, 0, 2, 3).reshape(steps_t, (b - a) * m,
                                                         1)
            ys, stats = solve(rhs[b - a], target[0], data["ts"], cfg["rtol"],
                              cfg["atol"], cfg["max_steps"])
            loss = torch.mean((ys - target) ** 2) * (b - a) / sims
            for k, g in zip(p, torch.autograd.grad(loss, list(p.values()))):
                grads[k] += g
            total += float(loss.detach())
            nfe, accepted = nfe + stats["nfe"], accepted + stats["accepted"]
        opt.update(p, grads)
        losses.append(total)
        log(json.dumps(dict(epoch=epoch, loss=total, nfe=nfe,
                            accepted=accepted,
                            seconds=time.perf_counter() - t0)))
    return {k: v.detach().cpu() for k, v in p.items()}, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cells.read_json(cells.HERE / "configs" / f"{CONFIG}.json")
    prog = cells.load_module(cells.HERE / "configs" / f"{CONFIG}.py")
    ref = cells.load_module(cells.HERE / "reference" / f"{CONFIG}.py")
    traffic = cells.read_json(cells.HERE / "traffic" / f"{TRAFFIC}.json")
    data = prog.make_data(cfg, traffic, SEED, device)
    weights = draw_weights(prog.weight_spec(cfg, data), SEED, device)
    trained, losses = train(cfg, ref, data, weights, EPOCHS, GROUP, device)
    meta = dict(config=CONFIG, traffic=TRAFFIC, seed=SEED, epochs=EPOCHS,
                group=GROUP, losses=losses,
                made_by="bench_torch/train_surrogate.py")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(weights=trained, meta=meta), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
