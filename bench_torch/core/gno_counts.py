"""Operations and compulsory bytes of the graph kernel network's layers,
counted from shapes by the rules of ``counts.py`` (a multiply-add is two
operations; a bias add, an activation, an add and a division one an
element; an activation's derivative two; each input read once and each
output written once, float32 values and int32 indices).

A ``GNOConv`` call, ``y = ReLU(W x + mean_{e→n} κ_e x[s_e] + b)`` with
``κ_e = reshape(ph_e Wl + bl, in × out)``, is counted at the least work of
K5, its reduce-then-contract form: the reduce ``S[n] = Σ_e x[s_e] ⊗ ph'_e``
(``E · IN · KB`` multiply-adds, ``ph' = [ph, 1]``, KB = K + 1 with the
bias) and the contraction ``S Wl'`` (``N · IN · KB · OUT``); then the mean's
division, the W product, the message's add, the bias and the ReLU. Its
backward: the ReLU's derivative, the bias's sum, the W product's two
gradients, the mean's division of the cotangent, the two products of the
contraction (``dS`` and ``dWl'``, S taken as given: neither its
recomputation nor its bytes are counted, so the count stays a lower bound
of any implementation's), ``dph`` (``E · IN · K``) and the per-edge ``dh``
(``E · IN · KB``) with its sum onto the senders. The graph is the edge-id
CSR K5 reads (an offset a row, an edge id and a weight a slot) and the
senders; the mean reads a degree a node.
"""
from __future__ import annotations

from .counts import F32, IDX, Work, csr_bytes


def _graph_bytes(n: int, e: int) -> int:
    """The edge-id CSR, the senders and the in-degrees."""
    return csr_bytes(n, e) + IDX * e + F32 * n


def gno_conv_forward(n: int, e: int, fin: int, fout: int, k: int,
                     bias: bool = True) -> Work:
    kb = k + int(bias)
    ops = (2 * e * fin * kb + 2 * n * fin * kb * fout  # K5
           + n * fout  # the mean's division
           + 2 * n * fin * fout + 3 * n * fout)  # W x, the add, b, ReLU
    nbytes = (F32 * (e * k + n * fin + fin * kb * fout + fin * fout + fout
                     + n * fout)
              + _graph_bytes(n, e))
    return Work(ops, nbytes)


def gno_conv_backward(n: int, e: int, fin: int, fout: int, k: int,
                      input_grad: bool, bias: bool = True) -> Work:
    kb = k + int(bias)
    ops = (2 * n * fout + n * fout  # ReLU's derivative, db
           + 2 * n * fin * fout  # dW
           + n * fout  # the mean's division of the cotangent
           + 2 * n * fout * fin * kb + 2 * n * fin * kb * fout  # dS, dWl'
           + 2 * e * fin * k)  # dph
    # gy, y, x, W, ph, Wl'; dW, db, dWl', dph
    nbytes = (F32 * (2 * n * fout + n * fin + fin * fout + e * k
                     + fin * kb * fout + fin * fout + fout + fin * kb * fout
                     + e * k)
              + _graph_bytes(n, e))
    if input_grad:
        # dx through W, the per-edge dh, its sum onto the senders, the add
        ops += 2 * n * fout * fin + 2 * e * fin * kb + e * fin + n * fin
        nbytes += F32 * n * fin
    return Work(ops, nbytes)


def kernel_net_forward(e: int, dims) -> Work:
    """The kernel network's layers but its last on ``e`` edges: ``dims =
    (edge features, hidden, ..., K)``, a product, a bias and a ReLU a
    layer."""
    ops = sum(2 * e * a * b + 2 * e * b for a, b in zip(dims, dims[1:]))
    params = sum(a * b + b for a, b in zip(dims, dims[1:]))
    return Work(ops, F32 * (e * dims[0] + params + e * dims[-1]))


def kernel_net_backward(e: int, dims) -> Work:
    """From the cotangent of its output: every layer's ReLU derivative,
    bias sum and weight gradient, and the input gradient of every layer but
    the first (the edges' features are data)."""
    ops = 0
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        ops += 2 * e * b + e * b + 2 * e * a * b
        if i > 0:
            ops += 2 * e * a * b
    params = sum(a * b + b for a, b in zip(dims, dims[1:]))
    # the cotangent, the saved activations, the weights; the gradients
    acts = sum(dims[1:])
    return Work(ops, F32 * (e * dims[-1] + e * acts + e * dims[0]
                            + 2 * params))


def mse(n: int) -> Work:
    """The mean squared error and its gradient: a difference, a square and
    the mean's add an element forward, the scaled difference back."""
    return Work(6 * n, F32 * 3 * n)
