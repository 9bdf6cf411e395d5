"""Point-set consolidation: midpoint upsampling and the bilateral normal
denoising (port of isopoints_tpu/ops/points.py:26-32, 113-235).

Fixed-capacity padded buffers with masks, as in the JAX package: each
round scatters into preallocated slots, and the round count is static, so
the loop needs no host synchronisation. `wlop`, `resample_uniformly`,
`ear_lop_move` and `remove_outliers` are not ported: no workload of either
package reaches them (ROADMAP Queue 1 item 14).
"""

import math
from typing import Optional, Tuple

import torch

from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.utils import eps_denom, fma, sqrt_rn, top_k


def num_valid(mask: torch.Tensor) -> torch.Tensor:
    """Valid entries per cloud: (B, P) -> (B,) int64."""
    return torch.sum(mask.long(), dim=-1)


def bbox_diag(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-cloud masked bounding-box diagonal length (B,) (points.py:26)."""
    m = mask[..., None]
    lo = torch.amin(torch.where(m, points, 1e10), dim=1)
    hi = torch.amax(torch.where(m, points, -1e10), dim=1)
    return torch.linalg.norm(hi - lo, dim=-1)


def midpoint_upsample(points: torch.Tensor, mask: torch.Tensor,
                      target_capacity: int,
                      n_target: Optional[torch.Tensor] = None,
                      neighborhood_size: int = 16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert midpoints (nn + 2p)/3 in the sparsest regions until each
    cloud holds `n_target` points (points.py:113-208).

    Each round: kNN (k = neighborhood_size, self excluded), every point
    offers its max-clearance midpoint, and the `capacity // 8` sparsest
    offers go into the next free slots. The round count is static:
    ceil(log2(max_new + 1)) + ceil(cap / max_new) + 2.

    points (B, P, 3), mask (B, P), P <= target_capacity (a wider seed
    raises: subsample it first). Returns (points (B, cap, 3), mask).
    """
    b, p, _ = points.shape
    cap = target_capacity
    if p > cap:
        raise ValueError(
            f"midpoint_upsample: seed width {p} exceeds target capacity "
            f"{cap}; subsample the seeds to <= capacity first")
    dev = points.device
    if n_target is None:
        n_target = torch.full((b,), cap, dtype=torch.long, device=dev)
    n_target = torch.clamp(n_target, max=cap)
    # front-compact: insertion appends at slot `count`, which must be free
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    mask = torch.gather(mask, 1, order)
    points = torch.gather(points, 1, order[..., None].expand(-1, -1, 3))
    buf = torch.zeros((b, cap + 1, 3), dtype=points.dtype, device=dev)
    bmask = torch.zeros((b, cap + 1), dtype=torch.bool, device=dev)
    buf[:, :p] = points
    bmask[:, :p] = mask
    max_new = max(cap // 8, 1)
    rounds = (max(1, math.ceil(math.log2(max_new + 1)))
              + -(-cap // max_new) + 2)
    j = torch.arange(max_new, device=dev)[None, :]
    third = torch.tensor(1.0 / 3.0, dtype=points.dtype, device=dev)
    for _ in range(rounds):
        pts, m = buf[:, :cap], bmask[:, :cap]
        counts = num_valid(m)
        res = knn_points(pts, pts, m, m, k=neighborhood_size,
                         exclude_self=True)
        nn = knn_gather(pts, res.idx)                             # (B,C,K,3)
        # XLA divides by the constant 3 as a product with its reciprocal
        s = nn + 2.0 * pts[:, :, None, :]
        mid = s * third
        # clearances |mid − nn'| rounded as XLA's CPU build of this fusion
        # rounds them: x subtracted from the rounded midpoint, y and z
        # contracted into one fma each, the squares summed as an fma chain
        # and a correctly rounded root
        nb = nn[:, :, None, :, :]
        dx = mid[:, :, :, None, 0] - nb[..., 0]                   # (B,C,K,K)
        dyz = fma(s[:, :, :, None, 1:], third, -nb[..., 1:])      # (B,C,K,K,2)
        d = sqrt_rn(fma(dyz[..., 1], dyz[..., 1],
                        fma(dyz[..., 0], dyz[..., 0], dx * dx)))
        d = torch.where(res.mask[:, :, None, :], d, float("inf"))
        clearance = torch.amin(d, dim=-1)
        clearance = torch.where(res.mask, clearance, float("-inf"))
        father_sparsity = torch.amax(clearance, dim=-1)
        father_nb = torch.argmax(clearance, dim=-1)
        father_sparsity = torch.where(m & torch.isfinite(father_sparsity),
                                      father_sparsity, float("-inf"))
        chosen = torch.gather(
            mid, 2, father_nb[:, :, None, None].expand(-1, -1, 1, 3))[:, :, 0]
        top_val, top_idx = top_k(father_sparsity, max_new)
        new_pts = torch.gather(chosen, 1, top_idx[..., None].expand(-1, -1, 3))
        top_ok = top_val > float("-inf")
        n_new = torch.minimum(torch.clamp(n_target - counts, max=max_new),
                              torch.sum(top_ok.long(), dim=-1))
        # the slot past the capacity takes every insert that is dropped
        slots = torch.where((j < n_new[:, None]) & top_ok, counts[:, None] + j,
                            cap)
        buf = buf.scatter(1, slots[..., None].expand(-1, -1, 3), new_pts)
        bmask = bmask.scatter(1, slots, True)
    return buf[:, :cap], bmask[:, :cap]


@torch.no_grad()
def denoise_normals_bilateral(points: torch.Tensor, normals: torch.Tensor,
                              mask: torch.Tensor, sharpness_sigma: float = 30.0,
                              neighborhood_size: int = 16) -> torch.Tensor:
    """Bilateral normal mollification (points.py:211-235): each valid
    point's unit normal becomes the weighted mean of its k nearest
    neighbours' (self excluded), weights exp(−((1 − ⟨n, nᵢ⟩)/σ_s)²) ·
    exp(−|p − pᵢ|²·σ_sp⁻¹) with σ_sp⁻¹ = (valid count)/2 and the spatial
    cutoff |p − pᵢ|² > 16/σ_sp⁻¹; masked points keep their unit normal."""
    normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True),
                                    min=1e-12)
    res = knn_points(points, points, mask, mask, k=neighborhood_size,
                     exclude_self=True)
    nn = knn_gather(points, res.idx)
    nn_normals = knn_gather(normals, res.idx)
    wn = (1.0 - torch.sum(nn_normals * normals[:, :, None, :], dim=-1)) / sharpness_sigma
    wn = torch.exp(-wn * wn)
    inv_sigma_sp = (num_valid(mask).float() / 2.0)[:, None, None]
    spatial_cut = 16.0 / torch.clamp(inv_sigma_sp, min=1e-12)
    d2 = torch.sum((nn - points[:, :, None, :]) ** 2, dim=-1)
    wp = torch.where(d2 > spatial_cut, 0.0, torch.exp(-d2 * inv_sigma_sp))
    w = torch.where(res.mask, wn * wp, 0.0)
    out = torch.sum(nn_normals * w[..., None], dim=-2) / \
        eps_denom(torch.sum(w, dim=-1, keepdim=True), 1e-12)
    out = out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)
    return torch.where(mask[..., None], out, normals)
