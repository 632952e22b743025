"""GenCast's graphs and synthetic 0.25° samples, for a traffic file with a
``gencast`` block: the inputs of one cell from its parameters and the run's
seed. The graphs are the same for every seed; the samples, the noise levels
and the noise are made on the device in bulk from the seed. Nothing of the
port is imported: the grid, the finest mesh and the grid ↔ mesh edge sets
are ``traffic.graphcast``'s own builders, unchanged (GenCast's encoder and
decoder edges are GraphCast's), and the mesh edges are the sides of the
finest mesh alone, both directions, sorted by receiver.

- Samples: ``samples`` inputs ``(grid points, inputs)`` (the two
  conditioning states, the forcings, the static fields and the positions'
  channels), residual targets ``(grid points, targets)``, every channel
  N(0, 1) (ERA5 is not in the repository; the shapes and the work are the
  published ones).
- Noise, one level and one field a sample (step ``k`` trains on sample ``k``
  modulo the samples): ``σ = (σ_max^{1/ρ} + u (σ_min^{1/ρ} −
  σ_max^{1/ρ}))^ρ``, ``u ~ U(0, 1)``, and ``ε`` N(0, 1) a grid point and
  target channel, drawn here so that the program and the reference see the
  same ``σ`` and ``ε``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import graphcast as gc
from .generate import streams, torch_gen


def build_graphs(spec: dict) -> dict:
    """The mix's graphs on the host: ``mesh`` ``(senders, receivers)``, the
    finest mesh's sides; ``g2m``, ``m2g``, ``mesh_x``, ``grid_lat`` and
    ``grid_lon`` as ``traffic.graphcast.build_graphs`` gives them."""
    out = gc.build_graphs({k: v for k, v in spec.items()
                           if k != "mesh_edges"})
    v, f = gc._icosahedron()
    for _ in range(spec["splits"]):
        v, f = gc._split(v, f)
    sides = gc._sides(f)
    ms, mr = gc._sorted(sides[:, 0], sides[:, 1])
    if spec.get("mesh_edges") not in (None, len(ms)):
        raise ValueError(f"gencast: mesh_edges {len(ms)}, the mix gives "
                         f"{spec['mesh_edges']}")
    out["mesh"] = (ms, mr)
    return out


def gencast(traffic: dict, seed: int, device) -> dict:
    """The mix's samples on ``device`` and its sizes, without its graphs:
    ``inputs`` ``(samples, grid points, inputs)``, ``targets`` ``(samples,
    grid points, targets)``, ``sigma`` ``(samples,)``, ``noise`` like
    ``targets``, float32 from the seed; ``area_weight`` on ``device``;
    ``loss_nodes`` None (all grid points); ``num_grid``, ``num_mesh`` and
    the edge counts as the block gives them."""
    spec, count = traffic["gencast"], traffic["samples"]
    lat = gc._grid_lat(spec)
    n = len(lat)
    data = dict(num_grid=n, num_mesh=spec["mesh_nodes"],
                **{k: spec[k] for k in ("mesh_edges", "grid2mesh_edges",
                                        "mesh2grid_edges")})
    gen = torch_gen(streams(seed)[1], device)
    data["inputs"] = torch.randn((count, n, spec["inputs"]), generator=gen,
                                 device=device)
    data["targets"] = torch.randn((count, n, spec["targets"]),
                                  generator=gen, device=device)
    u = torch.rand(count, generator=gen, device=device, dtype=torch.float64)
    inv = 1.0 / spec["rho"]
    hi, lo = spec["sigma_max"] ** inv, spec["sigma_min"] ** inv
    data["sigma"] = ((hi + u * (lo - hi)) ** spec["rho"]).float()
    data["noise"] = torch.randn((count, n, spec["targets"]), generator=gen,
                                device=device)
    data["area_weight"] = torch.from_numpy(gc.area_weights(lat)).to(device)
    data["loss_nodes"] = None
    return data
