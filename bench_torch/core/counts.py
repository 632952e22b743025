"""Operations and compulsory bytes of the layers, counted from shapes.

Counting rules (the same for every layer):

- a multiply-add is two operations; a bias add, an activation and a
  division one an element; an activation's derivative two an element;
- bytes: each input read once and each output written once, in float32
  (4 bytes) and int32 indices; intermediates that a fused implementation
  need not store are not counted, and neither is recomputation, so the
  count is a lower bound of any implementation's;
- a graph's normalized adjacency is counted as CSR: a value and a column
  per nonzero, an offset per row. On an undirected graph it is symmetric,
  so the backward reads the same matrix.

``Work`` is ``(ops, bytes)`` of one call; ``backward`` of a call is what
its gradient needs given the output's gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

F32 = 4
IDX = 4


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float
    bytes: float


def csr_bytes(rows: int, nnz: int, weighted: bool = True) -> int:
    return IDX * (rows + 1) + nnz * (IDX + (F32 if weighted else 0))


def gcn_forward(n: int, nnz: int, fin: int, fout: int) -> Work:
    """``act(Â x W + b)``, ``Â`` the degree-normalized adjacency with its
    self-loops (``nnz`` nonzeros): the SpMM at the narrower width (``x W``
    first when ``fout < fin``), the W product, the bias and the
    activation."""
    ops = 2 * nnz * min(fin, fout) + 2 * n * fin * fout + 2 * n * fout
    nbytes = (F32 * (n * fin + fin * fout + fout + n * fout)
              + csr_bytes(n, nnz))
    return Work(ops, nbytes)


def gcn_backward(n: int, nnz: int, fin: int, fout: int,
                 input_grad: bool) -> Work:
    """From ``gy``: ``g = gy ⊙ act'`` (from the saved output),
    ``h = Âᵀ g``, ``dW = xᵀ h``, ``db = Σ g``, and ``dx = h Wᵀ`` when the
    input needs its gradient."""
    ops = (2 * n * fout + n * fout + 2 * nnz * min(fin, fout)
           + 2 * n * fin * fout)
    nbytes = (F32 * (2 * n * fout + n * fin + fin * fout + fin * fout + fout)
              + csr_bytes(n, nnz))
    if input_grad:
        ops += 2 * n * fout * fin
        nbytes += F32 * n * fin
    return Work(ops, nbytes)


def _mlp_ops(rows: int, dims: Sequence[int], last_act: bool) -> float:
    """Forward of a Dense stack on ``rows`` rows: products, biases, and an
    activation after every layer but the last (unless ``last_act``)."""
    ops = 0.0
    for i in range(len(dims) - 1):
        ops += 2 * rows * dims[i] * dims[i + 1] + rows * dims[i + 1]
        if i < len(dims) - 2 or last_act:
            ops += rows * dims[i + 1]
    return ops


def _mlp_products(rows: int, dims: Sequence[int]) -> float:
    return sum(2 * rows * dims[i] * dims[i + 1]
               for i in range(len(dims) - 1))


def _mlp_params(dims: Sequence[int]) -> int:
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(dims) - 1))


def vmh_forward(n: int, e: int, state: int, pos: int,
                phi: Sequence[int], gamma: Sequence[int]) -> Work:
    """``m_i = mean_j ϕ(h_i, h_j − h_i, x_j − x_i)``, ``h_i' = γ(h_i,
    m_i)`` over ``e`` edges into ``n`` receivers. ϕ ends in a linear layer,
    and a mean commutes with it, so the least work reduces ϕ's penultimate
    activations per receiver and applies the last layer per node."""
    feats = e * (state + pos)  # the differences
    hidden = _mlp_ops(e, phi[:-1], last_act=True)
    reduce = e * phi[-2] + n * phi[-2]
    last = 2 * n * phi[-2] * phi[-1] + n * phi[-1]
    ops = feats + hidden + reduce + last + _mlp_ops(n, gamma, False)
    nbytes = (F32 * (n * state + n * pos + n * gamma[-1]
                     + _mlp_params(phi) + _mlp_params(gamma))
              + csr_bytes(n, e, weighted=False))
    return Work(ops, nbytes)


def vmh_backward(n: int, e: int, state: int, pos: int,
                 phi: Sequence[int], gamma: Sequence[int]) -> Work:
    """Both products of every layer (the input's and the weight's
    gradient) at the forward's rows, the activations' derivatives, the
    biases' sums, the mean's broadcast and the differences' scatter."""
    prods = 2 * (_mlp_products(e, phi[:-1])
                 + 2 * n * phi[-2] * phi[-1] + _mlp_products(n, gamma))
    acts = 2 * (e * sum(phi[1:-1]) + n * sum(gamma[1:-1]))
    biases = e * sum(phi[1:-1]) + n * (phi[-1] + sum(gamma[1:]))
    ops = prods + acts + biases + e * phi[-2] + e * (state + pos)
    params = _mlp_params(phi) + _mlp_params(gamma)
    nbytes = (F32 * (n * gamma[-1] + n * state + n * pos + params
                     + n * state + params)
              + csr_bytes(n, e, weighted=False))
    return Work(ops, nbytes)


def dense_forward(n: int, fin: int, fout: int) -> Work:
    return Work(2 * n * fin * fout + n * fout,
                F32 * (n * fin + fin * fout + fout + n * fout))


def dense_backward(n: int, fin: int, fout: int, input_grad: bool) -> Work:
    ops = 2 * n * fin * fout + n * fout + (2 * n * fin * fout
                                           if input_grad else 0)
    nbytes = F32 * (n * fout + n * fin + 2 * fin * fout + fout
                    + (n * fin if input_grad else 0))
    return Work(ops, nbytes)


def softmax_cross_entropy(n: int, c: int) -> Work:
    """Log-softmax, the picked log-likelihood and the masked mean, forward
    and backward: about 8 operations a logit."""
    return Work(8 * n * c, F32 * (2 * n * c + 2 * n))
