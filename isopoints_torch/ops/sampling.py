"""Point subset sampling: exact farthest point sampling (port of
isopoints_tpu/ops/sampling.py).

No kernel, in the JAX package (a `lax.scan` over the selections) as here
(a loop of `n_samples − 1` steps of a few device ops each, no host read).
It runs once per run, when the saliency reference cloud is seeded.
"""

from typing import Optional, Tuple

import torch

from isopoints_torch.ops.knn import dot3


def farthest_point_sampling(points: torch.Tensor, n_samples: int,
                            mask: Optional[torch.Tensor] = None,
                            start_idx: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact FPS (sampling.py:17-60). points (B, P, 3), mask (B, P).

    The first pick is each cloud's first valid index (0 when none is
    valid), whatever `start_idx`: the JAX function takes `start_idx` and
    never reads it (sampling.py:40-42), so neither does this one. Each later
    pick is the first index of the largest distance to
    the picks so far, invalid points held at −1 so that they never win.
    The squared distance is an fma chain over x, y, z (`dot3`), as XLA
    forms it on the CPU.

    Returns idx (B, n_samples) int64, which repeats when a cloud has fewer
    valid points than `n_samples`, and out_mask (B, n_samples), False past
    the cloud's valid count."""
    b, p, _ = points.shape
    dev = points.device
    if mask is None:
        mask = torch.ones((b, p), dtype=torch.bool, device=dev)
    first = torch.argmax(mask.to(torch.uint8), dim=-1)
    first = torch.where(mask.any(dim=-1), first, 0)
    min_d = torch.where(mask, float("inf"), -1.0).to(points.dtype)
    picks = [first]
    last = first
    for _ in range(n_samples - 1):
        sel = torch.gather(points, 1, last[:, None, None].expand(-1, 1, 3))
        diff = points - sel
        d = torch.where(mask, dot3(diff, diff), -1.0)
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        picks.append(last)
    idx = torch.stack(picks, dim=1)
    n_valid = torch.sum(mask.long(), dim=-1)
    out_mask = (torch.arange(n_samples, device=dev)[None, :]
                < torch.clamp(n_valid, max=n_samples)[:, None])
    return idx, out_mask


def fps_subsample(points: torch.Tensor, ratio: float,
                  mask: Optional[torch.Tensor] = None):
    """FPS by a ratio of the capacity (sampling.py:63-79): S = ceil(P·ratio)
    samples, and each cloud keeps ceil(n_valid·ratio) of them. Returns
    (sampled points (B, S, 3), out_mask (B, S), idx (B, S))."""
    b, p, _ = points.shape
    s = max(1, int(-(-p * ratio // 1)))
    if mask is None:
        mask = torch.ones((b, p), dtype=torch.bool, device=points.device)
    idx, out_mask = farthest_point_sampling(points, s, mask)
    n_valid = torch.sum(mask.long(), dim=-1)
    # float32 product as jnp forms it: the count is int32, the ratio weak
    want = torch.ceil(n_valid.to(torch.float32) * ratio).long()
    out_mask = out_mask & (torch.arange(s, device=points.device)[None, :]
                           < want[:, None])
    sampled = torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))
    return sampled, out_mask, idx
