"""Cora-shaped synthetic node-classification data, drawn from the same numpy
stream as ``neuralgraphpde.data.synthetic.synthetic_cora``."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graph.gnngraph import GnnGraph


@dataclasses.dataclass
class NodeClassificationData:
    graph: GnnGraph
    features: np.ndarray  # (N, F)
    labels: np.ndarray  # (N,)
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int


def synthetic_cora(
    num_nodes: int = 2708,
    num_edges: int = 10556,
    num_features: int = 1433,
    num_classes: int = 7,
    homophily: float = 0.8,
    seed: int = 0,
) -> NodeClassificationData:
    """Citation-network stand-in matching Cora's shape (2708 nodes, 10556
    directed edges): bag-of-words rows from class topics, edges that prefer
    same-class endpoints with probability ``homophily``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)

    words_per_class = num_features // num_classes
    feats = np.zeros((num_nodes, num_features), np.float32)
    active = rng.integers(10, 40, size=num_nodes)
    for i in range(num_nodes):
        c = labels[i]
        own = rng.integers(c * words_per_class, (c + 1) * words_per_class,
                           size=active[i])
        other = rng.integers(0, num_features, size=max(active[i] // 3, 1))
        feats[i, own] = 1.0
        feats[i, other] = 1.0

    m = num_edges // 2
    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    src = rng.integers(0, num_nodes, size=m)
    same = rng.random(m) < homophily
    dst = np.empty(m, np.int64)
    for k in range(m):
        if same[k]:
            pool = by_class[labels[src[k]]]
            dst[k] = pool[rng.integers(len(pool))]
        else:
            dst[k] = rng.integers(num_nodes)
    senders = np.concatenate([src, dst]).astype(np.int32)
    receivers = np.concatenate([dst, src]).astype(np.int32)

    g = GnnGraph.from_coo(senders, receivers, num_nodes=num_nodes)

    idx = rng.permutation(num_nodes)
    n_train, n_val = 140 * num_nodes // 2708, 500 * num_nodes // 2708
    train_mask = np.zeros(num_nodes, bool)
    val_mask = np.zeros(num_nodes, bool)
    test_mask = np.zeros(num_nodes, bool)
    train_mask[idx[:n_train]] = True
    val_mask[idx[n_train:n_train + n_val]] = True
    test_mask[idx[n_train + n_val:]] = True

    return NodeClassificationData(
        graph=g, features=feats, labels=labels.astype(np.int32),
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        num_classes=num_classes,
    )
