"""Losses of the warm-up step (port of isopoints_tpu/training/losses.py:
eikonal, BCE freespace / occupancy)."""

from typing import Optional

import torch
import torch.nn.functional as F


def reduce_loss(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                reduction: str = "mean") -> torch.Tensor:
    m = torch.ones_like(x) if mask is None else mask.to(x.dtype)
    if reduction == "sum":
        return torch.sum(x * m)
    if reduction == "mean":
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    if reduction == "none":
        return x * m
    raise ValueError(reduction)


def eikonal_loss(grad: torch.Tensor, mask=None, reduction: str = "mean"):
    """(|∇f| − 1)² (NormalLengthLoss)."""
    n = torch.linalg.norm(grad, dim=-1)
    return reduce_loss((n - 1.0) ** 2, mask, reduction)


def sdf_freespace_loss(sdf: torch.Tensor, alpha: float = 1.0, mask=None,
                       reduction: str = "sum"):
    """BCE(−α·sdf, 0): freespace points must have positive sdf."""
    return reduce_loss(F.softplus(-alpha * sdf), mask, reduction)


def sdf_occupancy_loss(sdf: torch.Tensor, alpha: float = 1.0, mask=None,
                       reduction: str = "sum"):
    """BCE(−α·sdf, 1): occupied points must have negative sdf."""
    return reduce_loss(F.softplus(alpha * sdf), mask, reduction)
