"""The benchmark's cells at a size a CPU test can hold: each traffic file's
``small`` parameters over its own (the same configurations and traffic
kinds, fewer nodes, simulations and fields)."""
from __future__ import annotations

import time

import torch

from bench_torch.core import cell as cells
from bench_torch.core import compare, rollout, train

CPU = torch.device("cpu")
BENCH = cells.read_json(cells.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [w["name"] for w in BENCH["workloads"]
         if cells.read_json(cells.HERE / "traffic" / f"{w['traffic']}.json")
         ["task"] == "train"]


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) and "kind" not in v
                  else v)
    return out


def load(name: str):
    cell = cells.load(name, BENCH)
    cell.traffic = _merge(cell.traffic, cell.traffic["small"])
    return cell


def run(cell, seed: int = 11, trace: bool = False, seconds: float = 0.5):
    """One run of ``cell`` on the CPU, as ``run.py`` makes it past its look
    for a card: ``(correct, result)``."""
    runner = {"train": train, "rollout": rollout}[cell.traffic["task"]]
    t0 = time.monotonic()
    result = runner.run(cell, seed, seconds, trace, CPU,
                        lambda: time.monotonic() - t0)
    ok, _ = compare.judge(result["numbers"], cell.limits)
    return ok and result["failed"] == 0, result
