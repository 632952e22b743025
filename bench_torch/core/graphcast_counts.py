"""Operations and compulsory bytes of GraphCast's layers, counted from shapes
by the rules of ``counts.py`` (a multiply-add is two operations; a bias
add, an activation, an add and a division one an element; an activation's
derivative two; each input read once and each output written once, float32
values and int32 indices), with a LayerNorm's:

- forward, an element: the mean's add, the difference, the variance's
  multiply-add, the normalization's multiply, the scale and offset's
  multiply-add: 7;
- backward, an element: the scale's gradient (a multiply-add) and the
  offset's (an add), the cotangent times the scale, the two row sums (an
  add and a multiply-add), and ``rstd · (g − mean − x̂ · mean')`` (an add,
  a multiply-add, a multiply): 11.

An ``MLP`` of ``dims`` counts every layer's product and bias, the
activation after every layer but the last, and the LayerNorm where it has
one. An ``InteractionConv`` call is counted at its least work: its edge
embedder where it has one; φ_e's first layer split (``W_e e`` on the edges,
``W_s v_s`` on the senders, ``W_r v_r`` and the bias on the receivers, the
two gathered adds), so the ``(E, 3 · latent)`` concatenation is not
counted; the rest of φ_e, the sum onto the receivers, φ_v on ``[v_r,
Σ m]``, the residuals. Its backward: every product's two gradients (none
for raw edge features), every bias's sum, the activations' derivatives,
the LayerNorms', the residuals' adds and the sums of the gathered
cotangents onto the senders and the receivers. Recomputation is not
counted, nor are intermediates a fused implementation need not store, so
every count is a lower bound of any implementation's.
"""
from __future__ import annotations

from .counts import F32, IDX, Work

LN_FWD, LN_BWD = 7, 11


def _params(dims, norm: bool) -> int:
    return (sum(a * b + b for a, b in zip(dims, dims[1:]))
            + (2 * dims[-1] if norm else 0))


def mlp_forward(n: int, dims, norm: bool) -> Work:
    """``MLP(dims)`` on ``n`` rows: products, biases, the activation after
    every layer but the last, the LayerNorm where ``norm``."""
    ops = sum(2 * n * a * b + n * b for a, b in zip(dims, dims[1:]))
    ops += n * sum(dims[1:-1])  # activations
    if norm:
        ops += LN_FWD * n * dims[-1]
    nbytes = F32 * (n * dims[0] + _params(dims, norm) + n * dims[-1])
    return Work(ops, nbytes)


def mlp_backward(n: int, dims, norm: bool, input_grad: bool) -> Work:
    """From the output's cotangent: the LayerNorm's backward, every
    layer's weight gradient and bias sum, the activations' derivatives,
    every layer's input gradient but the first's unless ``input_grad``."""
    ops = LN_BWD * n * dims[-1] if norm else 0
    pairs = list(zip(dims, dims[1:]))
    for i, (a, b) in enumerate(pairs):
        ops += 2 * n * a * b + n * b
        if i > 0 or input_grad:
            ops += 2 * n * a * b
    ops += 2 * n * sum(dims[1:-1])  # activations' derivatives
    # the cotangent, the saved input and output, the parameters; their
    # gradients (and the input's)
    nbytes = F32 * (2 * n * dims[-1] + n * dims[0] + 2 * _params(dims, norm)
                    + (n * dims[0] if input_grad else 0))
    return Work(ops, nbytes)


def _graph_bytes(n_r: int, e: int) -> int:
    """The senders and receivers, and the edge-id layout's row offsets."""
    return IDX * (2 * e + n_r + 1)


def interaction_forward(n_s: int, n_r: int, e: int, latent: int,
                        edge_in=None, keep_edges: bool = True) -> Work:
    """One ``InteractionConv`` call over ``e`` edges from ``n_s`` senders
    to ``n_r`` receivers; ``edge_in`` the raw edge features' width where
    the conv embeds them."""
    L = latent
    ops = 0
    if edge_in is not None:
        ops += mlp_forward(e, (edge_in, L, L), True).ops
    ops += (2 * n_s * L * L  # W_s v_s
            + 2 * n_r * L * L + n_r * L  # W_r v_r + b
            + 2 * e * L * L + 2 * e * L  # W_e e, the two gathered adds
            + e * L  # swish
            + 2 * e * L * L + e * L + LN_FWD * e * L  # second layer, LN
            + e * L)  # the sum onto the receivers
    ops += (keep_edges * e * L  # e + m
            + mlp_forward(n_r, (2 * L, L, L), True).ops + n_r * L)
    e_in = edge_in if edge_in is not None else L
    params = (_params((3 * L, L, L), True) + _params((2 * L, L, L), True)
              + (_params((edge_in, L, L), True) if edge_in else 0))
    nbytes = (F32 * (n_s * L + n_r * L + e * e_in + params + n_r * L
                     + keep_edges * e * L)
              + _graph_bytes(n_r, e))
    return Work(ops, nbytes)


def interaction_backward(n_s: int, n_r: int, e: int, latent: int,
                         edge_in=None, keep_edges: bool = True) -> Work:
    """The call's backward from the cotangents of its results, every input
    needing its gradient (the latents of the senders, the receivers and,
    without ``edge_in``, the edges)."""
    L = latent
    ops = (mlp_backward(n_r, (2 * L, L, L), True, True).ops
           + n_r * L  # the residual's add into dv_r
           + keep_edges * e * L  # the edge residual's add into de
           + LN_BWD * e * L + 4 * e * L * L + e * L  # LN, second layer
           + 2 * e * L  # swish'
           + 4 * e * L * L  # dW_e and de
           + 4 * n_s * L * L + e * L  # dW_s, dv_s, the senders' sum
           + 4 * n_r * L * L + e * L + n_r * L)  # dW_r, dv_r, sum, db
    if edge_in is not None:
        ops += mlp_backward(e, (edge_in, L, L), True, False).ops
    e_in = edge_in if edge_in is not None else L
    params = (_params((3 * L, L, L), True) + _params((2 * L, L, L), True)
              + (_params((edge_in, L, L), True) if edge_in else 0))
    # the cotangents in; the saved inputs; the parameters and their
    # gradients; the inputs' gradients out
    nbytes = (F32 * (n_r * L + keep_edges * e * L
                     + n_s * L + n_r * L + e * e_in + 2 * params
                     + n_s * L + n_r * L + (0 if edge_in else e * L))
              + _graph_bytes(n_r, e))
    return Work(ops, nbytes)


def weighted_mse(n: int, c: int) -> Work:
    """The prediction's residual add and the weighted MSE, forward (the
    add, the difference, the square, the channel weight, the mean's add an
    element; the node weight and the mean's add a node) and backward (the
    scaled difference, a multiply-add and a multiply an element)."""
    return Work(5 * n * c + 2 * n + 3 * n * c, F32 * (4 * n * c + 2 * n))
