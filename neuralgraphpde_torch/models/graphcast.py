"""GraphCast (Lam et al., *Learning skillful medium-range global weather
forecasting*, Science 382, 2023; arXiv:2212.12794): an encoder–processor–
decoder of interaction networks from a latitude–longitude grid to an
icosahedral multimesh and back, and the recomputation that lets one
0.25° sample train in true float32 on one card.

``GraphCast`` runs on the three graphs of ``graph.sphere.graphcast_graphs``
after ``precompute_graphs`` (``set_graphs``):

- embedders, each ``MLP(in → latent → latent)``, swish, LayerNorm: the
  grid's input channels, the mesh nodes' features and the mesh edges'
  features (Grid2Mesh and Mesh2Grid embed their own edges inside their
  convs);
- Grid2Mesh: one ``InteractionConv`` over the grid → mesh edges (the mesh
  nodes updated), then ``v_g ← v_g + MLP(v_g)`` on the grid;
- the processor: ``layers`` unshared ``InteractionConv``s on the multimesh;
- Mesh2Grid: one ``InteractionConv`` over the mesh → grid edges (the grid
  nodes updated);
- the output ``MLP(latent → latent → out)``, no LayerNorm: the normalized
  residual that the caller adds to the last input state.

``recompute=True`` sets every conv's ``schedule`` to ``recomputed``: the
call keeps only its inputs and its result for the backward, which runs it
again (``torch.utils.checkpoint``, in an ``ngpde.recompute`` span) for the
tensors its gradients need; where the conv's graph carries
``receiver_blocks`` (``precompute_graphs``' ``blocks``) each block of
receivers is one such unit, so a block's edge latents are alive only while
it runs. Under a profiler the encoder, processor and decoder run in
``ngpde.graphcast.encoder``, ``.processor`` and ``.decoder`` spans.

Counters (module attributes, like the kernels' ``launches``):
``interaction_forwards``, the interaction networks' passes over their
edges, forward and recomputed (a conv in blocks counts once per full pass);
``chunks``, receiver blocks run forward; ``recomputed_blocks``, units run
again in a backward (a processor layer, or one receiver block).
"""
from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..graph.sphere import GraphCastGraphs
from ..graph.transforms import receiver_blocks
from ..nn.basic import MLP
from ..nn.conv import Interaction, InteractionConv
from ..nn.gnn import AbstractGNNContainerLayer
from ..ops.spmm import precompute
from ..utils.profiling import annotate

interaction_forwards = 0
chunks = 0
recomputed_blocks = 0


_THIS = sys.modules[__name__]


def checkpointed(fn: Callable, *args, counters=_THIS,
                 rerun: Optional[Callable] = None,
                 on_recompute: Optional[Callable[[], None]] = None):
    """``fn(*args)`` under recomputation: its first run is the forward;
    every later run (the backward's) adds one to ``counters
    .recomputed_blocks`` (a model module: this one, or GenCast's), calls
    ``on_recompute`` and runs ``rerun`` (``fn`` if None) in an
    ``ngpde.recompute`` span."""
    runs = [0]

    def run(*args):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*args)
        counters.recomputed_blocks += 1
        if on_recompute is not None:
            on_recompute()
        with annotate("ngpde.recompute"):
            return (rerun or fn)(*args)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def recomputed(conv: InteractionConv, ps: torch.Tensor, v_r: torch.Tensor,
               e: torch.Tensor, cond: Optional[torch.Tensor] = None, *,
               counters=_THIS) -> Interaction:
    """An ``InteractionConv.schedule``: the call under recomputation when
    autograd records it, in the receiver blocks of ``conv.graph.cache
    ['receiver_blocks']`` where there are some (their results
    concatenated); the plain call otherwise. ``cond``: the conditioning
    vector of a conditioned conv (GenCast's), or None. The passes count
    in ``counters``, the model's module (this one by default)."""

    def unit(g, on_recompute, ps, v_r, e):
        return Interaction(*checkpointed(
            lambda *a: tuple(conv.block(*a[:3], g, a[3])), ps, v_r, e, cond,
            counters=counters, on_recompute=on_recompute))

    def done():
        counters.interaction_forwards += 1

    blocks = conv.graph.cache.get("receiver_blocks")
    if blocks is None:
        if not torch.is_grad_enabled():
            return conv.block(ps, v_r, e, conv.graph, cond)
        return unit(conv.graph, done, ps, v_r, e)
    left = [len(blocks)]

    def block_done():
        left[0] -= 1
        if left[0] == 0:
            done()

    outs = []
    for g, (r0, r1), (e0, e1) in blocks:
        counters.chunks += 1
        args = (ps, v_r[r0:r1], e[e0:e1])
        outs.append(unit(g, block_done, *args) if torch.is_grad_enabled()
                    else conv.block(*args, g, cond))
    edges = (torch.cat([o.edges for o in outs]) if conv.keep_edges
             else None)
    return Interaction(edges, torch.cat([o.nodes for o in outs]))


def precompute_graphs(graphs: GraphCastGraphs,
                      blocks: Sequence[int] = (1, 1)) -> dict:
    """``{'mesh', 'grid2mesh', 'mesh2grid'}``: each edge set after
    ``precompute(dense=False)`` (the segment layouts K1 reads), on the host;
    Grid2Mesh and Mesh2Grid cut into ``blocks`` receiver blocks, each
    precomputed, where their count is above 1."""
    out = {"mesh": precompute(graphs.mesh, dense=False, bsr=False)}
    for name, count in zip(("grid2mesh", "mesh2grid"), blocks):
        out[name] = precompute_bipartite(getattr(graphs, name), count)
    return out


def precompute_bipartite(g, count: int):
    """``g`` after ``precompute(dense=False)``, cut into ``count`` receiver
    blocks, each precomputed, where ``count`` is above 1."""
    if count > 1:
        cut = receiver_blocks(g, count, lambda b: precompute(b, dense=False))
        return g.copy(cache={"receiver_blocks": cut})
    return precompute(g, dense=False)


def area_weights(lat: np.ndarray) -> np.ndarray:
    """GraphCast's weight of each grid point in its loss: the area of its
    cell on an equiangular grid that holds both poles, ``cos φ · sin(Δφ /
    2)``, and ``sin(Δφ / 4)²`` at a pole, over the grid's mean; ``lat``
    in degrees, one entry a grid point."""
    lats = np.unique(lat)
    delta = np.deg2rad(lats[1] - lats[0])
    w = np.cos(np.deg2rad(lats)) * np.sin(delta / 2)
    w[[0, -1]] = np.sin(delta / 4) ** 2
    per_point = w[np.searchsorted(lats, lat)]
    return (per_point / per_point.mean()).astype(np.float32)


class GraphCast(AbstractGNNContainerLayer):
    """GraphCast's encoder–processor–decoder (module docstring).
    ``forward(x)``: the grid's input channels ``(grid points, grid_in)`` →
    the normalized residual ``(grid points, grid_out)``. The published
    0.25° model: ``grid_in`` 474, ``grid_out`` 227, ``latent`` 512,
    ``layers`` 16, node features 3, edge features 4. Children:
    ``grid_embed``, ``mesh_embed``, ``mesh_edge_embed``, ``grid2mesh``,
    ``grid_update``, ``processor`` (``layers`` convs), ``mesh2grid``,
    ``output``. Parameters are drawn from ``generator`` on the CPU and
    placed on ``device``."""

    layer_names = ("grid_embed", "mesh_embed", "mesh_edge_embed",
                   "grid2mesh", "grid_update", "processor", "mesh2grid",
                   "output")

    def __init__(self, grid_in: int = 474, grid_out: int = 227,
                 latent: int = 512, layers: int = 16, node_in: int = 3,
                 edge_in: int = 4, recompute: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)

        def mlp(a, norm=True, out=latent):
            return MLP((a, latent, out), "swish", layer_norm=norm, **kw)

        def conv(**extra):
            c = InteractionConv(latent, **extra, **kw)
            c.schedule = recomputed if recompute else None
            return c

        self.grid_embed = mlp(grid_in)
        self.mesh_embed = mlp(node_in)
        self.mesh_edge_embed = mlp(edge_in)
        self.grid2mesh = conv(edge_in=edge_in, keep_edges=False)
        self.grid_update = mlp(latent)
        self.processor = nn.ModuleList(conv() for _ in range(layers))
        self.mesh2grid = conv(edge_in=edge_in, keep_edges=False)
        self.output = mlp(latent, norm=False, out=grid_out)

    def set_graphs(self, graphs: dict) -> "GraphCast":
        """Hand each conv its edge set: ``graphs`` as ``precompute_graphs``
        returns them (moved to the model's device)."""
        self.grid2mesh.graph = graphs["grid2mesh"]
        self.mesh2grid.graph = graphs["mesh2grid"]
        for c in self.processor:
            c.graph = graphs["mesh"]
        self.graph = graphs["mesh"]
        return self

    def _conv(self, conv, v_s, v_r, e) -> Interaction:
        global interaction_forwards
        interaction_forwards += 1
        return conv(v_s, v_r, e)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.graph
        with annotate("ngpde.graphcast.encoder"):
            vg = self.grid_embed(x)
            vm = self.mesh_embed(mesh.ndata["x"])
            vm = self._conv(self.grid2mesh, vg, vm,
                            self.grid2mesh.graph.edata["e"]).nodes
            vg = vg + self.grid_update(vg)
            em = self.mesh_edge_embed(mesh.edata["e"])
        with annotate("ngpde.graphcast.processor"):
            for c in self.processor:
                em, vm = self._conv(c, vm, vm, em)
        with annotate("ngpde.graphcast.decoder"):
            vg = self._conv(self.mesh2grid, vm, vg,
                            self.mesh2grid.graph.edata["e"]).nodes
            return self.output(vg)
