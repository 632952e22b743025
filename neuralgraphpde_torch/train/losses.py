"""Loss functions for PDE training (counterparts of ``mse`` and
``rollout_mse`` in ``neuralgraphpde.train.losses``)."""
from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def rollout_mse(pred_traj: torch.Tensor,
                target_traj: torch.Tensor) -> torch.Tensor:
    """Mean squared error over a full ``(T, ...)`` rollout."""
    return torch.mean((pred_traj - target_traj) ** 2)
