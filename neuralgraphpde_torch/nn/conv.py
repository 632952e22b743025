"""GNN convolution layers (counterpart of ``neuralgraphpde.nn.conv``;
``GCNConv``, ``ExplicitEdgeConv``, ``VMHConv``, ``MPPDEConv`` and
``GNOConv`` so far), and GraphCast's ``InteractionConv`` and GenCast's
``MeshAttention`` and ``TransformerBlock``, which the JAX package does not
have."""
from __future__ import annotations

import warnings
import weakref
from typing import Callable, NamedTuple, Optional, Union

import torch
from torch import nn

from ..graph.transforms import add_self_loops as _add_self_loops
from ..ops.fused import (edge_mlp_aggregate, edge_mlp_fits, gcn_rhs,
                         gno_aggregate, mesh_attention)
from ..ops.message_passing import (aggregate_neighbors, apply_edges, copy_xj,
                                   e_mul_xj, node_degree, propagate,
                                   takes_edge_kernels, w_mul_xj)
from ..utils.profiling import annotate, annotated
from ..utils.state import drop
from ..ops.scatter import gather
from .basic import (MLP, Chain, ConditionalLayerNorm, Dense, glorot_normal,
                    glorot_uniform, make_params, matmul, resolve_activation,
                    zeros_init)
from .core import ContainerLayer
from .gnn import (INPUT_KEY, AbstractGNNContainerLayer, AbstractGNNLayer,
                  wrap_input)
from .graphed import CapturedCall, capture_key

Aggr = Union[str, Callable]
_PER_EDGE_SPAN = "ngpde.dispatch.per_edge"


class GCNConv(AbstractGNNLayer):
    """Degree-normalized graph convolution ``σ(W(D^{-1/2} Ã D^{-1/2} x) + b)``
    with optional bias, self-loops and stored or runtime edge weights, and
    the multiply-before-aggregate order when ``out_chs < in_chs``.

    Without edge weights, on a graph that ``precompute(...,
    add_self_loops=True)`` gave degree-normalized storage, the whole layer
    is one kernel call (K2, K4 or K7) where ``ops.fused.gcn_rhs`` takes it;
    otherwise the exact path runs. Under a profiler the forward is an
    ``ngpde.conv.GCNConv`` span holding ``ngpde.dispatch.<storage>_fused``
    or the SpMM's ``ngpde.dispatch.spmm.<mode>``.
    """

    def __init__(self, in_chs: int, out_chs: int,
                 activation: Union[None, str, Callable] = None,
                 initialgraph=None, *, init_weight=glorot_normal,
                 init_bias=zeros_init, use_bias: bool = True,
                 add_self_loops: bool = True, use_edge_weight: bool = False,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(initialgraph)
        self.in_chs, self.out_chs = in_chs, out_chs
        self.activation = activation
        self.add_self_loops = add_self_loops
        self.use_edge_weight = use_edge_weight
        make_params(self, in_chs, out_chs, use_bias, init_weight, init_bias,
                    generator, device, dtype)

    @annotated("ngpde.conv.GCNConv")
    def forward(self, x: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        g = self.graph
        looped = g.cache.get("self_looped", False)
        if edge_weight is not None and edge_weight.shape[0] != g.num_edges:
            # a pre-self-looped graph may get weights for its original edges
            if not (looped and
                    edge_weight.shape[0] == g.num_edges - g.num_nodes):
                raise ValueError(
                    f"wrong number of edge weights (expected {g.num_edges}, "
                    f"got {edge_weight.shape[0]})")

        if self.add_self_loops and not looped:
            if any(k in g.cache for k in ("adj", "tcsr", "banded", "bsr")):
                warnings.warn(
                    "GCNConv(add_self_loops=True) rebuilds the graph each "
                    "forward, discarding the SpMM structure attached by "
                    "ops.precompute — aggregation falls back to the scatter "
                    "path. Precompute on the self-looped graph instead: "
                    "g = precompute(g, add_self_loops=True).", stacklevel=2)
            g = _add_self_loops(g)
            if edge_weight is not None:
                edge_weight = torch.cat(
                    [edge_weight, edge_weight.new_ones(g.num_nodes)])
        elif (self.add_self_loops and edge_weight is not None
              and edge_weight.shape[0] != g.num_edges):
            # weights for the original edges of a pre-self-looped graph go
            # where precompute recorded them; loop edges keep weight 1
            pos = g.cache.get("orig_edge_pos")
            full = edge_weight.new_ones(g.num_edges)
            if pos is None:
                full[: edge_weight.shape[0]] = edge_weight
            else:
                full[pos.to(torch.int64)] = edge_weight
            edge_weight = full

        w, b = self.weight, self.bias
        premultiply = self.out_chs < self.in_chs
        if edge_weight is None and not self.use_edge_weight:
            y = gcn_rhs(g, self.activation, x, w, b, premultiply)
            if y is not None:
                return y

        if premultiply:
            x = matmul(x, w)
        if edge_weight is not None:
            dw = edge_weight
        elif self.use_edge_weight:
            dw = g.edata["e"].reshape(-1)
        else:
            dw = None
        d = node_degree(g, x.dtype, dw)
        c = torch.where(d > 0, 1.0 / torch.sqrt(d.clamp_min(1e-30)),
                        torch.zeros_like(d))
        x = x * c[:, None]
        if edge_weight is not None:
            x = propagate(e_mul_xj, g, "sum", xj=x, e=edge_weight)
        elif self.use_edge_weight:
            x = propagate(w_mul_xj, g, "sum", xj=x)
        else:
            x = propagate(copy_xj, g, "sum", xj=x)
        x = x * c[:, None]
        if not premultiply:
            x = matmul(x, w)
        if b is not None:
            x = x + b
        return resolve_activation(self.activation)(x)


# ------------------------------------------------------------------ fused ϕ
def _phi_layers(phi: nn.Module):
    """ϕ's layers, in order, when ϕ is a Dense or a Chain (or MLP); else
    None."""
    if isinstance(phi, Dense):
        return (phi,)
    if isinstance(phi, Chain):
        return tuple(getattr(phi, name) for name in phi.layer_names)
    return None


def _fused_layers(phi: nn.Module, aggr: Aggr):
    """ϕ's Dense layers when the fused kernel takes ϕ under ``aggr``
    (``ops.fused.edge_mlp_fits``); else None."""
    layers = _phi_layers(phi)
    if (not layers or not all(isinstance(l, Dense) for l in layers)
            or not edge_mlp_fits((l.activation for l in layers), aggr)):
        return None
    return layers


def fused_phi_plan(phi: nn.Module, aggr: Aggr):
    """``ops.fused.edge_mlp_aggregate``'s ``(acts, ws, bs, post)`` for ϕ
    under ``aggr``, or None where ``_fused_layers`` refuses ϕ. A linear last
    Dense (after another layer) is split off as ``post = (W, b)``, applied
    after the reduce: the kernel reduces the penultimate activations."""
    layers = _fused_layers(phi, aggr)
    if layers is None:
        return None
    post = None
    if len(layers) >= 2 and layers[-1].activation in (None, "identity"):
        post = (layers[-1].weight, layers[-1].bias)
        layers = layers[:-1]
    acts = tuple(l.activation for l in layers)
    ws = tuple(l.weight for l in layers)
    bs = tuple(l.bias if l.bias is not None
               else l.weight.new_zeros((1, l.out_dims)) for l in layers)
    return acts, ws, bs, post


def _phi_aggregate(phi, feats, g, aggr):
    """``aggr_{e→i} ϕ(feats_e)``: K3 where ``takes_edge_kernels`` holds
    and ``fused_phi_plan`` accepts ϕ, else ϕ on every edge then the
    segment reduce (``ngpde.dispatch.per_edge``)."""
    if takes_edge_kernels(g, feats):
        plan = fused_phi_plan(phi, aggr)
        if plan is not None:
            return edge_mlp_aggregate(plan, feats, g, aggr)
    with annotate(_PER_EDGE_SPAN):
        return aggregate_neighbors(g, aggr, phi(feats))


class ExplicitEdgeConv(AbstractGNNContainerLayer):
    """Edge convolution ``h_i' = aggr_{j∈N(i)} ϕ([h_i; h_j; x_j − x_i])``.

    ``x`` are the positions in ``g.ndata['x']``; the other ``ndata`` keys
    join the input features (``{**input, **g.ndata}``: ``ndata`` wins on a
    key collision), and the message is ``[h_i…, h_j…, x_j − x_i]`` in that
    key order. ϕ is the only child, so its parameter tree is the layer's
    own (``ContainerLayer.child_params``). Sum and mean may run through the
    fused edge-MLP kernel (K3); max and min run ϕ on every edge, then the
    segment-max kernel (K6) via ``aggregate_neighbors``.
    """

    layer_names = ("phi",)

    def __init__(self, phi: nn.Module, initialgraph=None,
                 aggr: Aggr = "mean"):
        super().__init__(initialgraph)
        self.phi = phi
        self.aggr = aggr

    @annotated("ngpde.conv.ExplicitEdgeConv")
    def forward(self, x) -> torch.Tensor:
        x = wrap_input(x)
        g = self.graph
        xs = {**x, **g.ndata}

        def edge_feats(xi, xj, e):
            posi, posj = xi["x"], xj["x"]
            hi, hj = drop(xi, "x"), drop(xj, "x")
            return torch.cat([*hi.values(), *hj.values(), posj - posi],
                             dim=-1)

        feats = apply_edges(edge_feats, g, xi=xs, xj=xs)
        return _phi_aggregate(self.phi, feats, g, self.aggr)


class VMHConv(AbstractGNNContainerLayer):
    """Iakovlev et al. (arXiv:2006.08956) convolution:
    ``m_i = aggr_j ϕ(h_i, h_j − h_i, x_j − x_i)``; ``h_i' = γ(h_i, m_i)``.

    ``h`` are the input features (a tensor, or a dict of them) and ``x``
    the positions in ``g.ndata['x']``. ϕ sees the receiver's features, the
    per-key differences and the position difference, concatenated in the
    order of ``{**input, **g.ndata}``; γ sees the input and the aggregated
    message. ϕ runs through the fused edge-MLP kernel where
    ``_phi_aggregate`` takes it. With autograd off, a tensor input on the
    card whose ϕ takes the fused kernel runs the whole forward as one
    replay of a captured CUDA graph (``vmh_graph``).
    """

    layer_names = ("phi", "gamma")

    def __init__(self, phi: nn.Module, gamma: nn.Module, initialgraph=None,
                 aggr: Aggr = "mean"):
        super().__init__(initialgraph)
        self.phi, self.gamma = phi, gamma
        self.aggr = aggr

    @annotated("ngpde.conv.VMHConv")
    def forward(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            y = vmh_graph(self, x)
            if y is not None:
                return y
        return self._eager(x)

    def _eager(self, x) -> torch.Tensor:
        x = wrap_input(x)
        g = self.graph
        xs = {**x, **g.ndata}

        def edge_feats(xi, xj, e):
            posi, posj = xi["x"], xj["x"]
            hi, hj = drop(xi, "x"), drop(xj, "x")
            return torch.cat([*hi.values(), *(hj[k] - hi[k] for k in hi),
                              posj - posi], dim=-1)

        feats = apply_edges(edge_feats, g, xi=xs, xj=xs)
        m = _phi_aggregate(self.phi, feats, g, self.aggr)
        return self.gamma(torch.cat([*x.values(), m], dim=-1))


# one captured forward a VMHConv (a new key replaces it and its memory
# pool); kept outside the module, so that copying or saving a model copies
# no graph
_CAPTURED = weakref.WeakKeyDictionary()


def vmh_graph(conv: VMHConv, x: torch.Tensor) -> Optional[torch.Tensor]:
    """``conv``'s forward of the tensor ``x`` as one replay of a captured
    CUDA graph (an ``ngpde.dispatch.vmh_graph`` span), or None where the
    eager path runs. It replays where ``capture_key`` admits the call
    (autograd off, ``x`` on the card, no capture in progress, registered
    parameters) and ``_phi_aggregate`` takes K3; the key is
    ``capture_key``'s. The first call under a key captures
    (``ngpde.dispatch.vmh_capture``). Counters: ``.captures``,
    ``.replays``, and ``.eager``, the tensor inputs that took the eager
    path."""
    got = capture_key(conv, x)
    if (got is None or not takes_edge_kernels(conv.graph, x)
            or _fused_layers(conv.phi, conv.aggr) is None):
        vmh_graph.eager += 1
        return None
    key, graphs = got
    call = _CAPTURED.get(conv)
    if call is None or call.key != key:
        _CAPTURED.pop(conv, None)
        with annotate("ngpde.dispatch.vmh_capture"):
            call = CapturedCall(key, conv._eager, torch.empty_like(
                x, memory_format=torch.contiguous_format).copy_(x),
                keep=graphs)
        _CAPTURED[conv] = call
        vmh_graph.captures += call.graph is not None
    if call.graph is None:
        vmh_graph.eager += 1
        return conv._eager(x)
    with annotate("ngpde.dispatch.vmh_graph"):
        y = call(x)
    vmh_graph.replays += 1
    return y


vmh_graph.captures = 0
vmh_graph.replays = 0
vmh_graph.eager = 0


# ------------------------------------------------------------------ GNO
def _values_cat(d, like: torch.Tensor, count: int) -> torch.Tensor:
    """Concat dict values in iteration order; an empty dict gives a
    ``(count, 0)`` tensor."""
    vals = list(d.values())
    if not vals:
        return like.new_zeros((count, 0))
    return torch.cat(vals, dim=-1)


class MPPDEConv(AbstractGNNContainerLayer):
    """Brandstetter et al. (arXiv:2202.03376) message-passing PDE layer:
    ``m_i = aggr_j ϕ(h_i, h_j, d_i − d_j, e_ij, θ)``;
    ``h_i' = ψ(h_i, m_i, θ)``.

    ``d`` are the ``g.ndata`` values in key order (for the MP-PDE solver
    ``{'u': window, 'x': positions}``), ``e`` the ``g.edata`` values, and θ
    the ``g.gdata`` values, detached and repeated per edge and per node in
    equal blocks per graph (a batch of graphs must share one structure).
    ϕ runs through ``_phi_aggregate``: the fused edge-MLP kernel (K3) for
    sum and mean, else ϕ on every edge then ``aggregate_neighbors`` (max
    and min: the segment-max kernel, K6).
    """

    layer_names = ("phi", "psi")

    def __init__(self, phi: nn.Module, psi: nn.Module, initialgraph=None,
                 aggr: Aggr = "mean"):
        super().__init__(initialgraph)
        self.phi, self.psi = phi, psi
        self.aggr = aggr

    @annotated("ngpde.conv.MPPDEConv")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.graph
        N, E, G = g.num_nodes, g.num_edges, g.num_graphs
        if N % G or E % G:
            raise ValueError(
                "MPPDEConv's θ broadcast needs identically-structured graphs "
                f"in a batch (N={N}, E={E}, num_graphs={G})")
        s = g.ndata
        theta = _values_cat(g.gdata, x, G).detach()
        theta_e = theta.repeat_interleave(E // G, dim=0)  # (E, Fθ)
        theta_n = theta.repeat_interleave(N // G, dim=0)  # (N, Fθ)

        def edge_feats(xi, xj, e_feat):
            di = _values_cat({k: xi[k] for k in s}, x, E)
            dj = _values_cat({k: xj[k] for k in s}, x, E)
            e_cat = _values_cat(e_feat or {}, x, E)
            return torch.cat([xi[INPUT_KEY], xj[INPUT_KEY], di - dj, e_cat,
                              theta_e], dim=-1)

        xs = {INPUT_KEY: x, **s}
        feats = apply_edges(edge_feats, g, xi=xs, xj=xs, e=g.edata)
        m = _phi_aggregate(self.phi, feats, g, self.aggr)
        return self.psi(torch.cat([x, m, theta_n], dim=-1))


class GNOConv(AbstractGNNContainerLayer):
    """Graph kernel network layer (Li et al., arXiv:2003.03485):
    ``m_i = aggr_j ϕ(e_ij) · h_j``; ``h_i' = σ(W h_i + m_i + b)``.

    ϕ maps each edge's features to a flattened ``in_chs × out_chs`` kernel
    matrix (row-major: ``w[e, i*out + o] ≡ W_e[i, o]``). The edge features
    are the receiver's ``g.ndata`` values, then the sender's, each in
    ``ndata``'s key order, then ``g.edata``'s values (for
    ``ndata = {'a', 'x'}``: ``[a_i, x_i, a_j, x_j]``).

    Fused path (``fused``): ϕ's prefix runs as plain layers, and its linear
    last layer, the per-edge matvec and the receiver sum run in K5 where
    ``ops.fused.gno_aggregate`` takes them. Otherwise the exact path
    builds every edge's ``(in, out)`` matrix and ``propagate``s the
    ``einsum('eio,ei->eo')`` messages.

    ``forward(x, ph)`` takes ϕ's prefix (every layer but its linear last,
    on every edge: ``phi_prefix``) made outside the call, where one conv
    runs several times on one graph: both paths then apply only ϕ's last
    layer to it, and autograd sums the calls' gradients into ``ph``.
    """

    layer_names = ("linear", "phi")

    def __init__(self, in_chs: int, out_chs: int, phi: nn.Module,
                 activation: Union[None, str, Callable] = None,
                 initialgraph=None, aggr: Aggr = "mean", *,
                 use_bias: bool = True, init_weight=glorot_uniform,
                 init_bias=zeros_init, fused: bool = True,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(initialgraph)
        self.in_chs, self.out_chs = in_chs, out_chs
        self.activation = activation
        self.aggr = aggr
        self.fused = fused
        self.linear = Dense(in_chs, out_chs, None, use_bias=use_bias,
                            init_weight=init_weight, init_bias=init_bias,
                            generator=generator, device=device, dtype=dtype)
        self.phi = phi

    def _edge_feats(self, g, like):
        """``[ndata_i..., ndata_j..., edata...]`` for every edge."""
        s, E = g.ndata, g.num_edges

        def feats(xi, xj, e):
            si = _values_cat({k: xi[k] for k in s}, like, E)
            sj = _values_cat({k: xj[k] for k in s}, like, E)
            return torch.cat([si, sj, _values_cat(e or {}, like, E)], dim=-1)

        return apply_edges(feats, g, xi=s, xj=s, e=g.edata)

    def _split_phi(self, required: bool = True):
        """``(prefix_layers, last_dense)`` when ϕ is a Dense or a Chain (or
        MLP) ending in a linear Dense (the kernel network's shape); else
        None, or a ValueError where ``required``."""
        layers = _phi_layers(self.phi)
        last = layers[-1] if layers else None
        if isinstance(last, Dense) and last.activation in (None, "identity"):
            return layers[:-1], last
        if required:
            raise ValueError("GNOConv: ϕ's prefix needs a ϕ that ends in a "
                             "linear Dense")
        return None

    def phi_prefix(self, like: torch.Tensor) -> torch.Tensor:
        """ϕ's layers but its linear last on every edge's features of the
        conv's graph, ``(num_edges, K)``; the features in ``like``'s
        dtype."""
        ph = self._edge_feats(self.graph, like)
        for layer in self._split_phi()[0]:
            ph = layer(ph)
        return ph

    @annotated("ngpde.conv.GNOConv")
    def forward(self, x: torch.Tensor,
                ph: Optional[torch.Tensor] = None) -> torch.Tensor:
        g = self.graph
        split = self._split_phi(required=ph is not None)
        m = None
        if self.fused and split is not None:
            m = gno_aggregate(
                g, self.aggr, x,
                ph if ph is not None else (lambda: self.phi_prefix(x)),
                split[1].weight, split[1].bias, self.in_chs, self.out_chs)
        if m is None:
            with annotate(_PER_EDGE_SPAN):
                E = g.num_edges
                w = (self.phi(self._edge_feats(g, x)) if ph is None
                     else split[1](ph))
                w = w.reshape(E, self.in_chs, self.out_chs)

                def message(xi, xj, e):
                    # in the dtype the two promote to, as jnp.einsum's
                    dtype = torch.promote_types(w.dtype, xj.dtype)
                    return torch.einsum("eio,ei->eo", w.to(dtype),
                                        xj.to(dtype))

                m = propagate(message, g, self.aggr, xj=x)
        y = matmul(x, self.linear.weight) + m
        if self.linear.bias is not None:
            y = y + self.linear.bias
        return resolve_activation(self.activation)(y)


class Interaction(NamedTuple):
    """What an ``InteractionConv`` call returns: the updated edge latents
    (None where the conv keeps none) and the updated receiver latents.
    ``grad_fn`` is the receivers' autograd node, the last the call makes,
    for module hooks that read a layer's output node."""

    edges: Optional[torch.Tensor]
    nodes: torch.Tensor

    @property
    def grad_fn(self):
        return self.nodes.grad_fn


class InteractionConv(AbstractGNNContainerLayer):
    """GraphCast's interaction network (Lam et al., arXiv:2212.12794, as its
    typed graph network runs one) on the conv's graph, senders → receivers
    (two node sets where the graph is bipartite), with the residuals:

        m_e = φ_e([e, v_s[s_e], v_r[r_e]]),    e' = e + m_e,
        v_r' = v_r + φ_v([v_r, Σ_{e→r} m_e]).

    φ_e and φ_v are ``MLP``s with one hidden layer of ``latent``, swish
    and a ``LayerNorm`` on the output. φ_e's first
    layer runs split, ``W [e, v_s, v_r] = W_e e + (W_s v_s)[s] + (W_r
    v_r)[r]``, so the node products run once a node and the ``(E, 3 ·
    latent)`` concatenation is never made; its weight is one ``(3 · latent,
    latent)`` parameter, rows in that order. The sum goes through
    ``aggregate_neighbors`` (K1 over the edge-id layout on the card).

    ``edge_in``: the conv embeds its edge input first with ``edge_embed``
    (``MLP(edge_in → latent → latent)``, LayerNorm): Grid2Mesh and
    Mesh2Grid take their raw edge features, whose latents live only inside
    the call. ``keep_edges=False`` returns no edge latents. ``cond``: the
    width of a conditioning vector that every LayerNorm of the conv takes
    (``ConditionalLayerNorm``, GenCast's); the call then takes the vector.

    ``forward(v_s, v_r, e, cond=None) -> Interaction``: the sender term
    ``W_s v_s`` once, then ``block`` over the conv's graph, or
    ``schedule(conv, ps, v_r, e, cond)`` where one is set
    (``models.graphcast.recomputed``: the call under recomputation, in
    receiver blocks where the graph carries them). Under a profiler the
    forward is an ``ngpde.conv.InteractionConv`` span."""

    def __init__(self, latent: int, initialgraph=None, *,
                 edge_in: Optional[int] = None, keep_edges: bool = True,
                 cond: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(initialgraph)
        kw = dict(layer_norm=True, cond=cond, generator=generator,
                  device=device, dtype=dtype)
        self.latent, self.keep_edges = latent, keep_edges
        names = ()
        self.edge_embed = None
        if edge_in is not None:
            self.edge_embed = MLP((edge_in, latent, latent), "swish", **kw)
            names = ("edge_embed",)
        self.edge_mlp = MLP((3 * latent, latent, latent), "swish", **kw)
        self.node_mlp = MLP((2 * latent, latent, latent), "swish", **kw)
        self.layer_names = names + ("edge_mlp", "node_mlp")
        self.schedule: Optional[Callable] = None

    def sender_term(self, v_s: torch.Tensor) -> torch.Tensor:
        """``W_s v_s``: φ_e's first layer's sender rows on every sender."""
        n = self.latent
        return matmul(v_s, self.edge_mlp.layer_1.weight[n:2 * n])

    def block(self, ps: torch.Tensor, v_r: torch.Tensor, e: torch.Tensor,
              g, cond: Optional[torch.Tensor] = None) -> Interaction:
        """One pass over ``g``'s edges: ``ps`` the sender term of every
        sender, ``v_r`` and ``e`` the latents of ``g``'s receivers and
        edges (the raw edge features with ``edge_in``)."""
        n = self.latent
        first, mlp = self.edge_mlp.layer_1, self.edge_mlp
        if self.edge_embed is not None:
            e = self.edge_embed(e, cond)
        pr = matmul(v_r, first.weight[2 * n:]) + first.bias
        h = (matmul(e, first.weight[:n]) + gather(ps, g.senders)
             + gather(pr, g.receivers))
        m = mlp.layer_2(resolve_activation(first.activation)(h))
        m = mlp.layer_3(m) if cond is None else mlp.layer_3(m, cond)
        agg = aggregate_neighbors(g, "sum", m)
        e = e + m if self.keep_edges else None
        v = v_r + self.node_mlp(torch.cat([v_r, agg], dim=-1), cond)
        return Interaction(e, v)

    @annotated("ngpde.conv.InteractionConv")
    def forward(self, v_s: torch.Tensor, v_r: torch.Tensor,
                e: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> Interaction:
        ps = self.sender_term(v_s)
        if self.schedule is not None:
            return self.schedule(self, ps, v_r, e, cond)
        return self.block(ps, v_r, e, self.graph, cond)


class MeshAttention(AbstractGNNLayer):
    """Multi-head attention over the neighbourhoods of the conv's graph:
    ``o_i = Σ_{j ∈ N(i)} softmax_j(q_i · k_j / √d) v_j`` per head, ``N(i)``
    the pairs of ``graph.cache['attention_layout']`` (GenCast's processor:
    each mesh node and every node within k hops of it; built by
    ``models.gencast.precompute_graphs``). No parameters: the projections
    are the transformer block's.

    ``forward(q, k, v)``: ``(nodes, heads · d)`` each, head ``h`` in
    columns ``h·d … (h + 1)·d``; the attended values, same shape. Where
    ``ops.spmm.takes_kernels`` holds, K8 (``ngpde.dispatch.mesh_attention``);
    otherwise its plain version, block row by block row
    (``ngpde.dispatch.mesh_attention_plain``). Under a profiler the forward
    is an ``ngpde.conv.MeshAttention`` span. ``attend`` is the same call
    without the module's hooks (the recomputation's)."""

    def __init__(self, heads: int, initialgraph=None):
        super().__init__(initialgraph)
        self.heads = heads

    def attend(self, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        with annotate("ngpde.conv.MeshAttention"):
            return mesh_attention(q, k, v,
                                  self.graph.cache["attention_layout"],
                                  self.heads)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        return self.attend(q, k, v)


class TransformerBlock(ContainerLayer):
    """A pre-norm transformer block over a mesh (GenCast's processor
    layer), every LayerNorm conditioned on ``cond``:

        h ← h + W_o · MeshAttention(W_q x, W_k x, W_v x),  x = CLN_1(h),
        h ← h + FFW(CLN_2(h)),  FFW = MLP(d → ffw → d, gelu).

    Children ``norm_1``, ``query``, ``key``, ``value``, ``attention``,
    ``proj``, ``norm_2``, ``ffw``; every Dense has a bias.
    ``forward(h, cond, hooks=True)``; ``hooks=False`` calls the attention's
    ``attend`` (a recomputation's run, which module hooks do not see)."""

    layer_names = ("norm_1", "query", "key", "value", "attention", "proj",
                   "norm_2", "ffw")

    def __init__(self, latent: int, heads: int, ffw: int, cond: int, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.norm_1 = ConditionalLayerNorm(latent, cond, **kw)
        self.query, self.key, self.value = (Dense(latent, latent, **kw)
                                            for _ in range(3))
        self.attention = MeshAttention(heads)
        self.proj = Dense(latent, latent, **kw)
        self.norm_2 = ConditionalLayerNorm(latent, cond, **kw)
        self.ffw = MLP((latent, ffw, latent), "gelu", **kw)

    def forward(self, h: torch.Tensor, cond: torch.Tensor,
                hooks: bool = True) -> torch.Tensor:
        x = self.norm_1(h, cond)
        attend = self.attention if hooks else self.attention.attend
        h = h + self.proj(attend(self.query(x), self.key(x), self.value(x)))
        return h + self.ffw(self.norm_2(h, cond))
