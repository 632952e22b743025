"""A cell's parts, found by name: its entry in ``BENCHMARK.json``, its
configuration (``configs/<config>.json`` and ``configs/<config>.py``), its
traffic mix (``traffic/<traffic>.json``), its limits and, for rollouts,
the saves compared (``workloads/<name>.json``) and its metrics' readers
(``metrics/<metric>.py``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from types import ModuleType
from typing import List

import torch

from ..traffic.generate import streams, torch_gen

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_module(path: Path) -> ModuleType:
    """A module from a file whose name need not be an identifier."""
    name = "bench_torch._loaded." + path.relative_to(HERE).with_suffix(
        "").as_posix().replace("/", ".").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    program: ModuleType  # configs/<config>.py
    reference: ModuleType  # reference/<config>.py
    traffic: dict
    limits: dict
    saves_compared: int  # rollouts: the saves compared, from the first
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench: dict = None) -> Cell:
    bench = bench or read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_file = next(c["file"] for c in bench["configs"]
                    if c["name"] == entry["config"])
    check = read_json(HERE / "workloads" / f"{name}.json")
    return Cell(
        name=name,
        config=read_json(ROOT / cfg_file),
        program=load_module(HERE / "configs" / f"{entry['config']}.py"),
        reference=load_module(HERE / "reference" / f"{entry['config']}.py"),
        traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=check["limits"],
        saves_compared=check.get("saves_compared", 0),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def read_metrics(per_layer: List[dict], ctx: dict) -> dict:
    """Each per-layer metric from its reader; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in per_layer:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def initial_weights(cell: Cell, data: dict, device) -> dict:
    """The weights a run starts from: the committed file
    ``weights/<name>.pt`` that the traffic's ``weights`` names (a trained
    model, made by ``train_surrogate.py`` with the plain reference), else
    drawn from the traffic's ``weights_seed``: one model for every seed, so
    that the seed changes the inputs and not the work."""
    spec = cell.program.weight_spec(cell.config, data)
    name = cell.traffic.get("weights")
    if name is None:
        return draw_weights(spec, cell.traffic["weights_seed"], device)
    saved = torch.load(HERE / "weights" / f"{name}.pt", map_location="cpu",
                       weights_only=True)["weights"]
    out = {}
    for leaf, shape, _ in spec:
        if tuple(saved[leaf].shape) != tuple(shape):
            raise ValueError(f"weights/{name}.pt: {leaf} is "
                             f"{tuple(saved[leaf].shape)}, not {shape}")
        out[leaf] = saved[leaf].to(device=device, dtype=torch.float32)
    return out


def draw_weights(spec, seed: int, device) -> dict:
    """Initial weights from the seed, on ``device``: one normal and one
    uniform draw for all leaves, cut and scaled per leaf. ``spec``:
    ``(name, shape, init)`` with ``init`` one of ``glorot_normal``,
    ``glorot_uniform``, ``zeros``; shapes are ``(in, out)`` or ``(1,
    out)``."""
    gen = torch_gen(streams(seed)[2], device)
    sizes = {kind: sum(math.prod(s) for _, s, k in spec if k == kind)
             for kind in ("glorot_normal", "glorot_uniform")}
    pools = {
        "glorot_normal": torch.randn(sizes["glorot_normal"], generator=gen,
                                     device=device),
        "glorot_uniform": torch.rand(sizes["glorot_uniform"], generator=gen,
                                     device=device),
    }
    offsets = dict.fromkeys(pools, 0)
    out = {}
    for name, shape, kind in spec:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        size = math.prod(shape)
        raw = pools[kind][offsets[kind]:offsets[kind] + size].view(shape)
        offsets[kind] += size
        fan = shape[0] + shape[1]
        out[name] = (raw * math.sqrt(2.0 / fan) if kind == "glorot_normal"
                     else (2.0 * raw - 1.0) * math.sqrt(6.0 / fan))
    return out
