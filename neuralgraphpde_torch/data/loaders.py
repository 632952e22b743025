"""Node-classification data from disk (counterpart of ``load_cora`` and
``cora_dataset`` in ``neuralgraphpde.data.loaders``).

- ``load_cora`` reads the LINQS Cora files (``cora.content`` and
  ``cora.cites``, each optionally gzipped), mirrors the citations, and draws
  the Planetoid-style split from a seeded numpy generator, as the JAX
  package does.
- ``cora_dataset`` is what the trainer calls: the files when a path is
  given, the shape-matched synthetic generator otherwise.
"""
from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from ..graph.gnngraph import GnnGraph
from .synthetic import NodeClassificationData, synthetic_cora


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rt")
    return open(path, "r")


def load_cora(path: str, *, seed: int = 0, n_train_per_class: int = 20,
              n_val: int = 500, n_test: int = 1000) -> NodeClassificationData:
    """Read ``<path>/cora.content`` (``<id> <w1..wF> <label>`` per line)
    and ``<path>/cora.cites`` (``<cited> <citing>``). Edges go both ways;
    the split takes ``n_train_per_class`` nodes of each class, then
    ``n_val`` and ``n_test`` from a seeded shuffle of the rest."""
    ids, rows, label_names = [], [], []
    with _open_maybe_gz(os.path.join(path, "cora.content")) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            ids.append(parts[0])
            rows.append(np.asarray(parts[1:-1], np.float32))
            label_names.append(parts[-1])
    feats = np.stack(rows)
    classes = sorted(set(label_names))
    labels = np.asarray([classes.index(l) for l in label_names], np.int32)
    id_of = {pid: i for i, pid in enumerate(ids)}
    n = len(ids)

    s_list, r_list = [], []
    with _open_maybe_gz(os.path.join(path, "cora.cites")) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            a, b = parts
            if a in id_of and b in id_of:
                s_list.append(id_of[a])
                r_list.append(id_of[b])
    src = np.asarray(s_list, np.int32)
    dst = np.asarray(r_list, np.int32)
    g = GnnGraph.from_coo(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), num_nodes=n)

    rng = np.random.default_rng(seed)
    train_mask = np.zeros(n, bool)
    for c in range(len(classes)):
        pool = np.flatnonzero(labels == c)
        train_mask[pool[rng.permutation(len(pool))[:n_train_per_class]]] = True
    rest = rng.permutation(np.flatnonzero(~train_mask))
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    val_mask[rest[:n_val]] = True
    test_mask[rest[n_val:n_val + n_test]] = True
    return NodeClassificationData(
        graph=g, features=feats, labels=labels, train_mask=train_mask,
        val_mask=val_mask, test_mask=test_mask, num_classes=len(classes))


def cora_dataset(path: Optional[str] = None, **synthetic_kwargs
                 ) -> NodeClassificationData:
    """Real Cora when ``path`` points at the LINQS files, otherwise
    ``synthetic_cora(**synthetic_kwargs)``."""
    if path:
        return load_cora(path, seed=synthetic_kwargs.get("seed", 0))
    return synthetic_cora(**synthetic_kwargs)
