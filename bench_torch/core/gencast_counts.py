"""Operations and compulsory bytes of GenCast's layers, counted from shapes
by the rules of ``counts.py`` (a multiply-add is two operations; an add,
a multiply, an exponential, a logarithm, a comparison and a division one
an element; each input read once and each output written once, float32
values), at its least work: over the pairs that attend alone, whatever the
kernel's tiles compute.

The attention over ``pairs`` (query, key) pairs, ``heads`` heads of
``d``:

- forward, a pair and head: the score ``q·k`` (2d), its scale (1), the
  running maximum (1), the exponential of the difference (2), the sum (1)
  and ``p v`` (2d): ``4d + 5``; a query and head: the division of the
  output (d) and the log-sum-exp (2);
- backward from the output's cotangent, the probabilities kept (no
  recomputation): ``dV += p dO`` (2d), ``dp = dO·v`` (2d), ``ds = p (dp −
  δ)`` (2), ``dQ += ds k`` (2d), ``dK += ds q`` (2d): ``8d + 2`` a pair
  and head, with ``δ = dO·O`` a query and head (2d) and the two scales of
  ``dQ`` and ``dK`` (2d a node and head);
- bytes: Q, K and V read and O written (forward); Q, K, V, O and dO read
  and dQ, dK and dV written (backward); the log-sum-exp a node and head
  written, then read. The neighbourhoods' description is not counted.

A transformer block: both conditional LayerNorms (a LayerNorm's 7 and 11
an element, ``graphcast_counts``; the conditioning's Dense maps of the
16-wide vector once a call, left out), the Q, K, V and output products
and biases, the attention, the FFW and the two residual adds, forward and
backward with every input's gradient.
"""
from __future__ import annotations

from .counts import F32, Work
from .graphcast_counts import LN_BWD, LN_FWD, mlp_backward, mlp_forward


def attention_forward(pairs: int, nodes: int, heads: int, d: int) -> Work:
    ph = pairs * heads
    ops = (4 * d + 5) * ph + nodes * heads * (d + 2)
    nbytes = F32 * (4 * nodes * heads * d + nodes * heads)
    return Work(ops, nbytes)


def attention_backward(pairs: int, nodes: int, heads: int, d: int) -> Work:
    ph = pairs * heads
    ops = (8 * d + 2) * ph + nodes * heads * 4 * d
    nbytes = F32 * (8 * nodes * heads * d + nodes * heads)
    return Work(ops, nbytes)


def block_forward(pairs: int, n: int, latent: int, heads: int,
                  ffw: int) -> Work:
    """One ``TransformerBlock`` on ``n`` nodes."""
    L = latent
    ops = (2 * LN_FWD * n * L  # the two conditional LayerNorms
           + 4 * (2 * n * L * L + n * L)  # Q, K, V and the projection
           + attention_forward(pairs, n, heads, L // heads).ops
           + mlp_forward(n, (L, ffw, L), False).ops
           + 2 * n * L)  # the residuals
    return Work(ops, 0)


def block_backward(pairs: int, n: int, latent: int, heads: int,
                   ffw: int) -> Work:
    L = latent
    ops = (2 * LN_BWD * n * L
           + 4 * (4 * n * L * L + n * L)  # dW, dx and db of each product
           + 2 * n * L  # Q's, K's and V's input gradients summed
           + attention_backward(pairs, n, heads, L // heads).ops
           + mlp_backward(n, (L, ffw, L), False, True).ops
           + 2 * n * L)  # the residuals' adds
    return Work(ops, 0)
