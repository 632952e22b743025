"""Layer base classes.

The JAX package's layers are Lux-style (``y, st = layer(x, ps, st)``); the
port's are ``nn.Module``s whose parameters are ``nn.Parameter``s and whose
forward is ``y = layer(x)``. ``ContainerLayer`` keeps the JAX rule for the
layout of parameter trees (used by ``interop.params_from_jax``): a container
with a single child flattens that child's parameters into its own level,
one with several nests them per child name.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from torch import nn


class Layer(nn.Module):
    """Base layer."""


class ContainerLayer(Layer):
    """A layer wrapping named sub-layers, listed in ``layer_names``."""

    layer_names: Tuple[str, ...] = ()

    def child_params(self, name: str, tree: Dict[str, Any]) -> Dict[str, Any]:
        """The part of a JAX parameter tree that belongs to child ``name``."""
        return tree if len(self.layer_names) == 1 else tree[name]
