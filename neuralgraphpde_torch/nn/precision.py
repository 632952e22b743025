"""Mixed-precision policy as a layer wrapper (counterpart of
``neuralgraphpde.nn.precision``): f32 master parameters, bf16 compute.

``Precision(layer)`` casts the floating inputs and the wrapped layer's
parameters to ``compute_dtype`` at call time, runs the layer unmodified
(``torch.func.functional_call`` with the cast parameters), and casts the
output to ``output_dtype``. The casts are ordinary autograd ops, so the
gradients arrive in the masters' dtype. Nothing else is cast: a graph's
node, edge and graph data stay as they are (the JAX wrapper casts only the
input and the parameters), so an f32 position in ``g.ndata`` promotes the
edge features built from it back to f32, and the fused kernels then read
f32 features with bf16 weights. There is no process-global switch: the
dtype is an argument of the wrapper.

Usage::

    model = bf16(vmh_model(...))   # or Precision(layer, compute_dtype=...)
    params_from_jax(model, ps)     # a single child: the layer's own tree
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from .core import ContainerLayer


def _cast_floats(tree, dtype: torch.dtype):
    """``tree`` (a tensor, or nested dicts, lists and tuples of them) with
    every floating tensor cast to ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    return tree


class Precision(ContainerLayer):
    """Run ``layer`` in ``compute_dtype``; parameters stay in their own
    (master) dtype and the output comes back in ``output_dtype``."""

    layer_names = ("layer",)

    def __init__(self, layer: nn.Module,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 output_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer = layer
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype

    def forward(self, x):
        params = {name: _cast_floats(p, self.compute_dtype)
                  for name, p in self.layer.named_parameters()}
        y = functional_call(self.layer, params,
                            (_cast_floats(x, self.compute_dtype),))
        return _cast_floats(y, self.output_dtype)


def bf16(layer: nn.Module) -> Precision:
    """f32 master parameters, bf16 compute, f32 outputs."""
    return Precision(layer)
