"""The readings that the limits of ``correct`` are set from, at a cell's
own size, on several seeds in one process.

    python3 bench_torch/control.py --workload NAME --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--out FILE.json]

For every seed: the numbers of the sound program (its first three
training steps, or rollouts of the mix's sample of fields, as a run makes
them) against the plain reference. For every control seed: the control,
the reference in the next precision down from the configuration's true
float32 (TF32 products), against the reference; and for a training cell
the planted half-batch fault, the reference on half the batch. A state
left unchanged reads 1 on ``change_gap`` by that number's measure and
needs no run. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from bench_torch.core import cell as cells  # noqa: E402
from bench_torch.core import compare, train  # noqa: E402
from bench_torch.core.cell import initial_weights  # noqa: E402


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest), with ``x``'s
    gradient."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


@contextlib.contextmanager
def lower_precision(device):
    """Matrix products in TF32: on the card by cuBLAS's own switch; on the
    CPU, which has no TF32, by rounding both operands of ``@`` to it."""
    if device.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return
    matmul = torch.Tensor.__matmul__
    torch.Tensor.__matmul__ = lambda a, b: matmul(_tf32(a), _tf32(b))
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul


def train_readings(cell, seed, device, control: bool) -> dict:
    cfg, mod, ref_mod = cell.config, cell.program, cell.reference
    data = mod.make_data(cfg, cell.traffic, seed, device)
    weights = initial_weights(cell, data, device)
    prog = mod.train_program(cfg, data, device, weights)
    checked = train.first_steps(prog)
    prog.close()
    del prog
    train.free(device)
    steps = train.CHECKED_STEPS
    ref = ref_mod.train(cfg, data, weights, steps, device)
    out = {"program": compare.training(checked, ref)}
    if control:
        with lower_precision(device):
            low = ref_mod.train(cfg, data, weights, steps, device)
        out["control"] = compare.training(low, ref)
        half = ref_mod.train(cfg, mod.half_batch(data), weights, steps,
                             device)
        out["half_batch"] = compare.training(half, ref)
    return out


def rollout_readings(cell, seed, device, control: bool) -> dict:
    cfg, mod, ref_mod = cell.config, cell.program, cell.reference
    data = mod.make_data(cfg, cell.traffic, seed, device)
    weights = initial_weights(cell, data, device)
    prog = mod.rollout_program(cfg, data, device,
                               {k: v.clone() for k, v in weights.items()})
    fields = data["fields"][: cell.traffic["sample"]]
    got = [prog.request(f)[0] for f in fields]
    prog.close()
    del prog
    train.free(device)
    ref = [ref_mod.rollout(cfg, data, weights, f.to(device)).cpu()
           for f in fields]
    out = {"program": compare.trajectories(got, ref, cell.saves_compared),
           "program_by_save": compare.by_save(got, ref)}
    if control:
        with lower_precision(device):
            low = [ref_mod.rollout(cfg, data, weights, f.to(device)).cpu()
                   for f in fields]
        out["control"] = compare.trajectories(low, ref, cell.saves_compared)
        out["control_by_save"] = compare.by_save(low, ref)
    return out


def readings(cell, seeds, control_seeds, device) -> list:
    fn = (train_readings if cell.traffic["task"] == "train"
          else rollout_readings)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        rec = dict(seed=seed, **fn(cell, seed, device,
                                   seed in control_seeds))
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    cell = cells.load(args.workload)
    recs = readings(cell, ints(args.seeds), ints(args.control_seeds),
                    torch.device("cuda", 0))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
