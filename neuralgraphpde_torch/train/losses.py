"""Loss functions (counterparts of ``neuralgraphpde.train.losses``): masked
softmax cross-entropy and accuracy for node classification, MSE and rollout
MSE for PDE training, the weighted MSE GraphCast trains on, and GenCast's
EDM-weighted form of it."""
from __future__ import annotations

import torch


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the masked nodes: logits ``(N,
    C)``, integer labels ``(N,)``, boolean mask ``(N,)``."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels.to(torch.int64)[:, None])[:, 0]
    mask = mask.to(logits.dtype)
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Share of the masked nodes whose arg-max logit is their label."""
    hit = (logits.argmax(-1) == labels).to(torch.float32)
    mask = mask.to(torch.float32)
    return (hit * mask).sum() / mask.sum().clamp_min(1.0)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 node_weight: torch.Tensor,
                 channel_weight: torch.Tensor) -> torch.Tensor:
    """``mean_n w_n · mean_c w_c (pred − target)²`` over ``(N, C)``:
    GraphCast's loss, ``w_n`` each grid point's area weight and ``w_c``
    each variable and level's weight."""
    err = (pred - target) ** 2 * channel_weight
    return (err.mean(dim=-1) * node_weight).mean()


def edm_weighted_mse(denoised: torch.Tensor, target: torch.Tensor,
                     sigma: torch.Tensor, node_weight: torch.Tensor,
                     channel_weight: torch.Tensor) -> torch.Tensor:
    """``λ(σ) · weighted_mse(denoised, target)``, ``λ(σ) = (σ² + 1) / σ²``:
    GenCast's denoising loss (EDM's weighting at σ_data = 1)."""
    s2 = sigma * sigma
    return (s2 + 1.0) / s2 * weighted_mse(denoised, target, node_weight,
                                          channel_weight)


def rollout_mse(pred_traj: torch.Tensor,
                target_traj: torch.Tensor) -> torch.Tensor:
    """Mean squared error over a full ``(T, ...)`` rollout."""
    return torch.mean((pred_traj - target_traj) ** 2)
