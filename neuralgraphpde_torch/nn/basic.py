"""Basic layers: ``Dense``, ``Chain``, ``MLP``, ``LayerNorm``,
``ConditionalLayerNorm``, activations and initializers.

Row-major convention as in the JAX package: inputs are ``(entities,
features)`` and weights are stored ``(in, out)``, so the forward is
``x @ W + b`` with bias ``(1, out)`` (not ``nn.Linear``'s ``(out, in)``).
Initializers draw from an explicit ``torch.Generator`` on the CPU.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .core import ContainerLayer, Layer


def glorot_uniform(generator, shape, dtype=torch.float32):
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * limit


def glorot_normal(generator, shape, dtype=torch.float32):
    std = math.sqrt(2.0 / (shape[0] + shape[1]))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def zeros_init(generator, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


_ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "swish": F.silu,
    "silu": F.silu,
    "softplus": F.softplus,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
}


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype the two promote to, returned in ``x``'s dtype
    (the JAX package's ``jnp.dot(x, w, preferred_element_type=x.dtype)``):
    under the precision policy an f32 activation meets bf16 weights and
    stays f32."""
    if x.dtype == w.dtype:
        return x @ w
    dtype = torch.promote_types(x.dtype, w.dtype)
    return (x.to(dtype) @ w.to(dtype)).to(x.dtype)


def resolve_activation(act: Union[None, str, Callable]) -> Callable:
    if act is None:
        return _ACTIVATIONS["identity"]
    if callable(act):
        return act
    return _ACTIVATIONS[act]


def make_params(layer: nn.Module, in_dims: int, out_dims: int, use_bias: bool,
                init_weight: Callable, init_bias: Callable,
                generator: Optional[torch.Generator], device, dtype) -> None:
    """Register ``weight`` ``(in, out)`` and ``bias`` ``(1, out)`` (or
    None) on ``layer``."""
    w = init_weight(generator, (in_dims, out_dims), dtype)
    layer.weight = nn.Parameter(w.to(device))
    if use_bias:
        b = init_bias(generator, (1, out_dims), dtype)
        layer.bias = nn.Parameter(b.to(device))
    else:
        layer.register_parameter("bias", None)


class Dense(Layer):
    """``y = act(x @ W + b)``."""

    def __init__(self, in_dims: int, out_dims: int,
                 activation: Union[None, str, Callable] = None, *,
                 use_bias: bool = True, init_weight=glorot_uniform,
                 init_bias=zeros_init,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_dims, self.out_dims = in_dims, out_dims
        self.activation = activation
        make_params(self, in_dims, out_dims, use_bias, init_weight, init_bias,
                    generator, device, dtype)

    def forward(self, x):
        y = matmul(x, self.weight)
        if self.bias is not None:
            y = y + self.bias
        return resolve_activation(self.activation)(y)


class LayerNorm(Layer):
    """``(x − mean) / sqrt(var + 1e-5) · scale + offset`` over the last
    dimension (Haiku's ``LayerNorm`` with its scale and offset, as GraphCast
    uses it): ``weight`` is the scale ``(1, dims)``, ones; ``bias`` the
    offset ``(1, dims)``, zeros."""

    eps = 1e-5

    def __init__(self, dims: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.dims = dims
        self.weight = nn.Parameter(torch.ones((1, dims), dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros((1, dims), dtype=dtype,
                                             device=device))

    def forward(self, x):
        return F.layer_norm(x, (self.dims,), self.weight.view(-1),
                            self.bias.view(-1), self.eps)


class ConditionalLayerNorm(ContainerLayer):
    """``LN(x) · (1 + W_s c + b_s) + W_o c + b_o``: a LayerNorm whose scale
    and offset are Dense maps of a conditioning vector ``c`` ``(1,
    cond_dims)`` (GenCast's noise-level conditioning of every LayerNorm).
    Children ``scale`` and ``offset``, each ``Dense(cond_dims → dims)``;
    with their weights and biases zero it is ``LayerNorm`` at its initial
    scale and offset. ``forward(x, cond)``."""

    eps = LayerNorm.eps
    layer_names = ("scale", "offset")

    def __init__(self, dims: int, cond_dims: int, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.dims = dims
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.scale = Dense(cond_dims, dims, **kw)
        self.offset = Dense(cond_dims, dims, **kw)

    def forward(self, x, cond):
        y = F.layer_norm(x, (self.dims,), None, None, self.eps)
        return y * (1.0 + self.scale(cond)) + self.offset(cond)


class Chain(ContainerLayer):
    """Sequential container with children ``layer_1..layer_N``; parameter
    trees always nest per child, even for one child."""

    def __init__(self, layers: Iterable[nn.Module]):
        super().__init__()
        names = []
        for i, layer in enumerate(layers):
            name = f"layer_{i + 1}"
            self.add_module(name, layer)
            names.append(name)
        self.layer_names = tuple(names)

    def child_params(self, name, tree):
        return tree[name]

    def forward(self, x):
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return x


class MLP(Chain):
    """Dense stack ``dims[0] → … → dims[-1]``: ``activation`` after every
    layer but the last, ``final_activation`` after the last. Its children
    are the Dense layers themselves (``layer_1..layer_N``), so its
    parameter tree is the JAX ``MLP``'s (that of its inner Chain).
    ``layer_norm=True`` ends it in a ``LayerNorm`` of the output, one more
    child (GraphCast's MLPs); with ``cond`` (the conditioning vector's
    width) that child is a ``ConditionalLayerNorm`` and ``forward(x,
    cond)`` hands it the vector (GenCast's MLPs)."""

    def __init__(self, dims, activation: Union[str, Callable] = "tanh",
                 final_activation: Union[None, str, Callable] = None, *,
                 use_bias: bool = True, layer_norm: bool = False,
                 cond: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        dims = tuple(dims)
        n = len(dims) - 1
        layers = [Dense(dims[i], dims[i + 1],
                        activation if i < n - 1 else final_activation,
                        use_bias=use_bias, generator=generator,
                        device=device, dtype=dtype)
                  for i in range(n)]
        if layer_norm:
            layers.append(
                LayerNorm(dims[-1], device=device, dtype=dtype)
                if cond is None else
                ConditionalLayerNorm(dims[-1], cond, generator=generator,
                                     device=device, dtype=dtype))
        super().__init__(layers)

    def forward(self, x, cond=None):
        for name in self.layer_names:
            layer = getattr(self, name)
            x = (layer(x, cond) if isinstance(layer, ConditionalLayerNorm)
                 else layer(x))
        return x
