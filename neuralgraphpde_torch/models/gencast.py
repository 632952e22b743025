"""GenCast (Price et al., *Probabilistic weather forecasting with machine
learning*, Nature 2025; arXiv:2312.15796): a diffusion model whose
denoiser is an encoder–processor–decoder from the latitude–longitude grid
to the finest icosahedral mesh and back, with a sparse transformer as its
processor and every LayerNorm conditioned on the noise level.

``GenCast`` runs on the graphs of ``graph.sphere.gencast_graphs`` after
``precompute_graphs`` (``set_graphs``). ``forward(inputs, noisy, sigma)``
is the denoiser ``D(z; σ) = c_skip z + c_out F(c_in z, c_noise, inputs)``
with EDM's preconditioning (Karras et al., arXiv:2206.00364, σ_data = 1:
``c_skip = 1/(σ² + 1)``, ``c_out = σ/√(σ² + 1)``, ``c_in = 1/√(σ² + 1)``,
``c_noise = ln σ``), where F is:

- the noise encoder: ``c_noise`` as sinusoidal features (``frequencies``
  angular frequencies ``2π/P · P^{k/(K−1)}``, ``P`` the base period, sin
  and cos of each), then ``MLP(2K → 32 → 16, gelu)``: the conditioning
  vector ``c``;
- embedders ``MLP(in → latent → latent)``, swish, ``ConditionalLayerNorm``
  on ``c``: the grid's input channels ``[inputs, c_in z]`` and the mesh
  nodes' features;
- Grid2Mesh: GraphCast's ``InteractionConv`` over the grid → mesh edges,
  its LayerNorms conditioned on ``c``, then ``v_g ← v_g + MLP(v_g)``;
- the processor: ``layers`` ``TransformerBlock``s over the mesh, each
  node attending to itself and to every node within ``k`` hops (the
  layout ``precompute_graphs`` builds), FFW ``latent → ffw → latent``,
  gelu;
- Mesh2Grid: ``InteractionConv`` over the mesh → grid edges, conditioned;
- the output ``MLP(latent → latent → out)``, no LayerNorm.

``recompute=True`` runs Grid2Mesh and Mesh2Grid under GraphCast's
``recomputed`` (in their receiver blocks) and every processor layer under
``torch.utils.checkpoint``: a layer keeps its input alone and runs again in
the backward, in an ``ngpde.recompute`` span, calling the attention's
``attend`` so that module hooks see each layer's call once. Spans:
``ngpde.gencast.noise`` (the noise encoder and the preconditioning),
``ngpde.gencast.encoder``, ``.processor``, ``.decoder``.

Counters (module attributes): ``interaction_forwards``, ``chunks`` and
``recomputed_blocks`` as GraphCast's (its Grid2Mesh and Mesh2Grid passes,
their receiver blocks run forward, and the units run again in a backward:
the processor layers and the receiver blocks).
"""
from __future__ import annotations

import functools
import math
import sys
from typing import Optional, Sequence

import torch
from torch import nn

from ..graph.sphere import GenCastGraphs, khop_bits
from ..kernels.attention_kernels import build_attention_layout
from ..nn.basic import MLP
from ..nn.conv import InteractionConv, TransformerBlock
from ..nn.gnn import AbstractGNNContainerLayer
from ..utils.profiling import annotate
from .graphcast import checkpointed, precompute_bipartite, recomputed

interaction_forwards = 0
chunks = 0
recomputed_blocks = 0


_THIS = sys.modules[__name__]


def precompute_graphs(graphs: GenCastGraphs, hops: int,
                      blocks: Sequence[int] = (1, 1), device=None) -> dict:
    """``{'mesh', 'grid2mesh', 'mesh2grid'}``: the mesh with the attention
    layout of its ``hops``-hop neighbourhoods in ``cache
    ['attention_layout']`` (``graph.sphere.khop_bits`` run on ``device``),
    and Grid2Mesh and Mesh2Grid as GraphCast's ``precompute_graphs`` makes
    them, in ``blocks`` receiver blocks; the layout on ``device``, the
    rest on the host."""
    mesh = graphs.mesh
    s, r = mesh.host_coo
    bits = khop_bits(s, r, mesh.num_nodes, hops, device)
    layout = build_attention_layout(bits, mesh.num_nodes)
    del bits
    out = {"mesh": mesh.copy(cache={"attention_layout": layout})}
    for name, count in zip(("grid2mesh", "mesh2grid"), blocks):
        out[name] = precompute_bipartite(getattr(graphs, name), count)
    return out


def edm_coefficients(sigma: torch.Tensor):
    """``(c_skip, c_out, c_in, c_noise)`` at noise level ``sigma``
    (σ_data = 1)."""
    s2 = sigma * sigma + 1.0
    return 1.0 / s2, sigma / s2.sqrt(), 1.0 / s2.sqrt(), sigma.log()


def fourier_features(x: torch.Tensor, frequencies: int,
                     base_period: float) -> torch.Tensor:
    """``(1, 2K)``: ``[sin(ω_k x), cos(ω_k x)]``, ``ω_k = 2π/P ·
    P^{k/(K−1)}``, of a 0-d ``x``."""
    k = torch.arange(frequencies, dtype=x.dtype, device=x.device)
    w = (2.0 * math.pi / base_period) * base_period ** (
        k / max(1, frequencies - 1))
    a = (w * x)[None]
    return torch.cat([a.sin(), a.cos()], dim=-1)


class GenCast(AbstractGNNContainerLayer):
    """GenCast's denoiser (module docstring). The published 0.25° model:
    ``grid_in`` 272 (the two conditioning states, forcings, static fields
    and positions, 188 channels, then the 84 of ``c_in z``), ``grid_out``
    84, ``latent`` 512, ``layers`` 16, ``heads`` 4, ``ffw`` 2048, node
    features 3, edge features 4. Children: ``noise_encoder``,
    ``grid_embed``, ``mesh_embed``, ``grid2mesh``, ``grid_update``,
    ``processor`` (``layers`` blocks), ``mesh2grid``, ``output``.
    Parameters are drawn from ``generator`` on the CPU and placed on
    ``device``."""

    layer_names = ("noise_encoder", "grid_embed", "mesh_embed", "grid2mesh",
                   "grid_update", "processor", "mesh2grid", "output")

    def __init__(self, grid_in: int = 272, grid_out: int = 84,
                 latent: int = 512, layers: int = 16, heads: int = 4,
                 ffw: int = 2048, node_in: int = 3, edge_in: int = 4,
                 frequencies: int = 32, base_period: float = 16.0,
                 noise_mlp: Sequence[int] = (32, 16),
                 recompute: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        cond = noise_mlp[-1]
        self.frequencies, self.base_period = frequencies, base_period
        self.recompute = recompute
        self.noise_encoder = MLP((2 * frequencies, *noise_mlp), "gelu", **kw)

        def mlp(a, norm=True, out=latent):
            return MLP((a, latent, out), "swish", layer_norm=norm,
                       cond=cond if norm else None, **kw)

        def conv():
            c = InteractionConv(latent, edge_in=edge_in, keep_edges=False,
                                cond=cond, **kw)
            c.schedule = (functools.partial(recomputed, counters=_THIS)
                          if recompute else None)
            return c

        self.grid_embed = mlp(grid_in)
        self.mesh_embed = mlp(node_in)
        self.grid2mesh = conv()
        self.grid_update = mlp(latent)
        self.processor = nn.ModuleList(
            TransformerBlock(latent, heads, ffw, cond, **kw)
            for _ in range(layers))
        self.mesh2grid = conv()
        self.output = mlp(latent, norm=False, out=grid_out)

    def set_graphs(self, graphs: dict) -> "GenCast":
        """Hand each conv its graph: ``graphs`` as ``precompute_graphs``
        returns them (moved to the model's device)."""
        self.grid2mesh.graph = graphs["grid2mesh"]
        self.mesh2grid.graph = graphs["mesh2grid"]
        for block in self.processor:
            block.attention.graph = graphs["mesh"]
        self.graph = graphs["mesh"]
        return self

    def _bipartite(self, conv, v_s, v_r, cond) -> torch.Tensor:
        global interaction_forwards
        interaction_forwards += 1
        return conv(v_s, v_r, conv.graph.edata["e"], cond).nodes

    def network(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """F: the grid's input channels ``(grid points, grid_in)`` and the
        conditioning vector ``(1, 16)`` → ``(grid points, grid_out)``."""
        with annotate("ngpde.gencast.encoder"):
            vg = self.grid_embed(x, cond)
            vm = self.mesh_embed(self.graph.ndata["x"], cond)
            vm = self._bipartite(self.grid2mesh, vg, vm, cond)
            vg = vg + self.grid_update(vg, cond)
        with annotate("ngpde.gencast.processor"):
            checked = self.recompute and torch.is_grad_enabled()
            for block in self.processor:
                vm = (checkpointed(block, vm, cond, counters=_THIS,
                                   rerun=functools.partial(block,
                                                           hooks=False))
                      if checked else block(vm, cond))
        with annotate("ngpde.gencast.decoder"):
            vg = self._bipartite(self.mesh2grid, vm, vg, cond)
            return self.output(vg)

    def forward(self, inputs: torch.Tensor, noisy: torch.Tensor,
                sigma: torch.Tensor) -> torch.Tensor:
        """``D(z; σ)``: ``inputs`` ``(grid points, grid_in − grid_out)``,
        the noisy residual ``z`` ``(grid points, grid_out)``, ``sigma`` a
        0-d tensor."""
        with annotate("ngpde.gencast.noise"):
            c_skip, c_out, c_in, c_noise = edm_coefficients(sigma)
            cond = self.noise_encoder(fourier_features(
                c_noise, self.frequencies, self.base_period))
            x = torch.cat([inputs, c_in * noisy], dim=-1)
        f = self.network(x, cond)
        with annotate("ngpde.gencast.noise"):
            return c_skip * noisy + c_out * f
