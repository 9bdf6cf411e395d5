"""Fragment compositors (port of isopoints_tpu/rendering/compositor.py):
plain gathers and weighted sums over the K fragments of a pixel, normalised
as pytorch3d's `NormWeightedCompositor` or not (`weighted_sum`). The JAX
package has no kernel here and neither has the port."""

from typing import Optional

import torch


def gather_fragments(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a per-point table (B, P, C) at the fragments' point ids
    (B, S, S, K) -> (B, S, S, K, C); an empty fragment (−1) reads row 0."""
    b, c = table.shape[0], table.shape[-1]
    safe = torch.where(idx >= 0, idx, 0).reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(table, 1, safe).reshape(idx.shape + (c,))


def weighted_sum_composite(idx: torch.Tensor, weights: torch.Tensor,
                           features: torch.Tensor,
                           gathered_features: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Σ_k w_k·f_k over the valid fragments, unnormalised
    (compositor.py:15-37). idx, weights (B, S, S, K), features (B, P, C) ->
    (B, S, S, C)."""
    if gathered_features is None:
        gathered_features = gather_fragments(features, idx)
    w = torch.where(idx >= 0, weights, 0.0)[..., None]
    return torch.sum(gathered_features * w, dim=-2)


def norm_weighted_sum_composite(idx: torch.Tensor, weights: torch.Tensor,
                                features: torch.Tensor, eps: float = 1e-10,
                                gathered_features: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Σ_k w_k·f_k / max(Σ_k w_k, eps) over the valid fragments
    (compositor.py:40-54). idx, weights (B, S, S, K), features (B, P, C) ->
    (B, S, S, C). `gathered_features`: the (B, S, S, K, C) rows, when the
    caller has them already."""
    if gathered_features is None:
        gathered_features = gather_fragments(features, idx)
    w = torch.where(idx >= 0, weights, 0.0)
    total = torch.sum(w, dim=-1, keepdim=True)
    wn = w / torch.clamp(total, min=eps)
    return torch.sum(gathered_features * wn[..., None], dim=-2)
