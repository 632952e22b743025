"""Graph container for the PyTorch port.

``GnnGraph`` mirrors ``neuralgraphpde.graph.gnngraph.GnnGraph``:

- COO connectivity as ``senders``/``receivers`` int32 tensors with plain-int
  ``num_nodes``/``num_edges``/``num_graphs``.
- Feature stores ``ndata``/``edata``/``gdata`` are dicts of row-major
  tensors with a leading entity dimension (``(num_nodes, F)`` etc.); key
  order is the caller's insertion order.
- A bipartite graph (senders and receivers in different node sets) gives
  the senders' count as ``num_senders``; ``num_nodes`` counts the
  receivers' set, which aggregation reduces onto and node features live
  on. ``num_senders`` is None where both ends index one node set.
- ``cache`` holds the aggregation structure ``ops.precompute`` attaches
  (dense adjacency, CSR layouts, DIA matrices); ``host_coo`` keeps the numpy
  copy of the edge list so host-side builds never read back from the device.

The graph is an ordinary Python object, not a module: layers keep it as
state (``update_graph``) and never register it as a parameter. ``to(device)``
moves every tensor, the cache included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

FeatureDict = Dict[str, torch.Tensor]

# Bare (non-dict) feature arrays are stored under these keys, as in the JAX
# package.
NDATA_DEFAULT_KEY = "x"
EDATA_DEFAULT_KEY = "e"
GDATA_DEFAULT_KEY = "u"


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(np.asarray(arr))


def _normalize_features(
    data: Union[None, Any, Mapping[str, Any]],
    num_entities: int,
    default_key: str,
    what: str,
) -> FeatureDict:
    """Normalize a feature argument into a dict of 2-D+ tensors."""
    if data is None:
        return {}
    items = dict(data) if isinstance(data, Mapping) else {default_key: data}
    out = {}
    for key, arr in items.items():
        arr = _as_tensor(arr)
        if arr.dim() == 1:
            if num_entities == 1 and arr.shape[0] != 1:
                arr = arr.reshape(1, -1)
            else:
                arr = arr.reshape(-1, 1)
        if arr.shape[0] != num_entities:
            raise ValueError(
                f"{what}[{key!r}] has leading dim {arr.shape[0]}, expected "
                f"{num_entities} (row-major (num_entities, features) layout)")
        out[key] = arr
    return out


def _move(value, device):
    """Cache entries are tensors, layouts with a ``to`` method, or flags."""
    if isinstance(value, torch.Tensor) or hasattr(value, "to"):
        return value.to(device)
    return value


@dataclasses.dataclass(frozen=True, eq=False)
class GnnGraph:
    """A (possibly batched) directed graph with node/edge/graph features.

    Edges are ``senders[k] -> receivers[k]``; aggregation reduces onto
    ``receivers``.
    """

    senders: torch.Tensor  # (num_edges,) int32
    receivers: torch.Tensor  # (num_edges,) int32
    ndata: FeatureDict
    edata: FeatureDict
    gdata: FeatureDict
    graph_indicator: Optional[torch.Tensor]
    num_nodes: int
    num_edges: int
    num_graphs: int = 1
    receivers_sorted: bool = False
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)
    host_coo: Optional[tuple] = dataclasses.field(default=None, repr=False)
    num_senders: Optional[int] = None

    @property
    def bipartite(self) -> bool:
        return self.num_senders is not None

    @classmethod
    def from_coo(
        cls,
        senders,
        receivers,
        *,
        num_nodes: Optional[int] = None,
        ndata=None,
        edata=None,
        gdata=None,
        num_graphs: int = 1,
        graph_indicator=None,
        sort_by_receiver: bool = False,
        num_senders: Optional[int] = None,
    ) -> "GnnGraph":
        """Build from COO index arrays. Host input (lists, numpy) is also
        kept as ``host_coo``. ``num_senders``: the sender node set's size
        where it is not the receivers' (a bipartite graph)."""
        host_coo = None
        if not isinstance(senders, torch.Tensor):
            host_coo = (np.asarray(senders, np.int32),
                        np.asarray(receivers, np.int32))
            senders = torch.from_numpy(host_coo[0].copy())
            receivers = torch.from_numpy(host_coo[1].copy())
        else:
            senders = senders.to(torch.int32)
            receivers = torch.as_tensor(receivers).to(torch.int32)
        if senders.shape != receivers.shape or senders.dim() != 1:
            raise ValueError(
                "senders/receivers must be equal-length 1D arrays")
        num_edges = int(senders.shape[0])
        if num_nodes is None:
            if num_edges == 0:
                num_nodes = 0
            elif host_coo is not None:
                num_nodes = int(max(host_coo[0].max(), host_coo[1].max()) + 1)
            else:
                num_nodes = int(max(int(senders.max()),
                                    int(receivers.max())) + 1)
        ndata = _normalize_features(ndata, num_nodes, NDATA_DEFAULT_KEY,
                                    "ndata")
        edata = _normalize_features(edata, num_edges, EDATA_DEFAULT_KEY,
                                    "edata")
        gdata = _normalize_features(gdata, num_graphs, GDATA_DEFAULT_KEY,
                                    "gdata")
        receivers_sorted = False
        if sort_by_receiver and num_edges > 0:
            if host_coo is not None:
                perm_np = np.argsort(host_coo[1], kind="stable")
                host_coo = (host_coo[0][perm_np], host_coo[1][perm_np])
                senders = torch.from_numpy(host_coo[0].copy())
                receivers = torch.from_numpy(host_coo[1].copy())
                perm = torch.from_numpy(perm_np)
            else:
                perm = torch.argsort(receivers, stable=True)
                senders, receivers = senders[perm], receivers[perm]
            edata = {k: v[perm.to(v.device)] for k, v in edata.items()}
            receivers_sorted = True
        elif num_edges > 0 and host_coo is not None:
            r = host_coo[1]
            receivers_sorted = bool(np.all(r[1:] >= r[:-1]))
        if graph_indicator is not None:
            graph_indicator = _as_tensor(graph_indicator).to(torch.int32)
        return cls(
            senders=senders, receivers=receivers, ndata=ndata, edata=edata,
            gdata=gdata, graph_indicator=graph_indicator,
            num_nodes=num_nodes, num_edges=num_edges, num_graphs=num_graphs,
            receivers_sorted=receivers_sorted, host_coo=host_coo,
            num_senders=num_senders)

    def replace(self, **kwargs) -> "GnnGraph":
        """Constructor-copy with overrides; feature overrides are
        normalized like ``from_coo``'s."""
        sizes = {"ndata": (self.num_nodes, NDATA_DEFAULT_KEY),
                 "edata": (self.num_edges, EDATA_DEFAULT_KEY),
                 "gdata": (self.num_graphs, GDATA_DEFAULT_KEY)}
        for key, (n, default) in sizes.items():
            if key in kwargs:
                kwargs[key] = _normalize_features(kwargs[key], n, default, key)
        return dataclasses.replace(self, **kwargs)

    def copy(self, **kwargs) -> "GnnGraph":
        """Shallow copy: same tensors, new wrapper."""
        return self.replace(**kwargs) if kwargs else dataclasses.replace(self)

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def to(self, device) -> "GnnGraph":
        """Copy of the graph with every tensor (cache included) on
        ``device``; ``host_coo`` stays on the host."""
        device = torch.device(device)
        return dataclasses.replace(
            self,
            senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            ndata={k: v.to(device) for k, v in self.ndata.items()},
            edata={k: v.to(device) for k, v in self.edata.items()},
            gdata={k: v.to(device) for k, v in self.gdata.items()},
            graph_indicator=(None if self.graph_indicator is None
                             else self.graph_indicator.to(device)),
            cache={k: _move(v, device) for k, v in self.cache.items()},
        )

    def __repr__(self):
        feat = lambda d: {k: tuple(v.shape) for k, v in d.items()}
        return (
            f"GnnGraph(num_nodes={self.num_nodes}, "
            f"num_edges={self.num_edges}, "
            f"num_graphs={self.num_graphs}, ndata={feat(self.ndata)}, "
            f"edata={feat(self.edata)}, gdata={feat(self.gdata)})")


def empty_graph() -> GnnGraph:
    """The "no graph yet" default a layer holds until ``update_graph``."""
    return GnnGraph.from_coo(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             num_nodes=0)
