"""Load the JAX package's parameter trees into the port's modules.

A JAX model's parameters ``ps`` are a nested dict (``layer_1/weight``,
``layer_2/layer_1/weight``, ...). Containers follow the Lux rule kept in
``nn.core.ContainerLayer``: a ``Chain`` (and an ``MLP``) nests each child
under its name, as does a container of several children such as
``VMHConv`` (``phi/layer_1/weight``, ``gamma/...``) or ``MPPDESolver``
(``encoder``, ``conv_1/phi/...``, ``decoder``); a single-child container
such as ``NeuralGraphODE`` or ``ExplicitEdgeConv`` flattens its child's
tree into its own level. Both packages store weights ``(in, out)`` and biases
``(1, out)``, so arrays copy over unchanged.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .nn.core import ContainerLayer


def params_from_jax(module: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy ``tree`` (nested dict of numpy arrays) into ``module``'s
    parameters in place; raise on a missing, extra or misshapen entry.
    Returns ``module``."""
    if isinstance(module, ContainerLayer):
        for name in module.layer_names:
            params_from_jax(getattr(module, name),
                            module.child_params(name, tree))
        return module
    own = dict(module.named_parameters(recurse=False))
    if set(own) != set(tree):
        raise KeyError(f"{type(module).__name__}: parameters {sorted(own)} "
                       f"vs JAX tree {sorted(tree)}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(tree[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{type(module).__name__}.{name}: shape "
                                 f"{tuple(p.shape)} vs JAX {arr.shape}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return module
