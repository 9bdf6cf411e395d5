"""Point-set consolidation: outlier removal, WLOP, midpoint upsampling,
the uniform resample, EAR's LOP move and the bilateral normal denoising
(port of isopoints_tpu/ops/points.py).

Fixed-capacity padded buffers with masks, as in the JAX package: each
round scatters into preallocated slots, and the round count is static, so
the loops need no host synchronisation. Every neighbour query is
`knn_points` (the kNN kernel on CUDA tensors); the frames are
`utils.mathutils.local_coord_frames` and the WLOP seeds `fps_subsample`.
WLOP's random jitter is an explicit argument (standard normal draws shaped
like its seeds) or is drawn from a `torch.Generator`.
"""

import math
from typing import Optional, Tuple

import torch

from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.ops.sampling import fps_subsample
from isopoints_torch.utils import eps_denom, fma, num_valid, sqrt_rn, top_k
from isopoints_torch.utils.mathutils import local_coord_frames


def bbox_diag(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-cloud masked bounding-box diagonal length (B,) (points.py:26)."""
    m = mask[..., None]
    lo = torch.amin(torch.where(m, points, 1e10), dim=1)
    hi = torch.amax(torch.where(m, points, -1e10), dim=1)
    return torch.linalg.norm(hi - lo, dim=-1)


@torch.no_grad()
def remove_outliers(points: torch.Tensor, mask: torch.Tensor,
                    neighborhood_size: int = 16, tolerance: float = 0.05
                    ) -> torch.Tensor:
    """The mask with every point dropped whose neighbourhood's variance
    ratio λ0/Σλ is not below `tolerance` (points.py:35-48): the k nearest
    neighbours include the point itself, so a far outlier contributes its
    own out-of-plane variance."""
    res = knn_points(points, points, mask, mask, k=neighborhood_size)
    nn = knn_gather(points, res.idx)
    evals, _ = local_coord_frames(points, nn, res.mask)
    ratio = evals[..., 0] / eps_denom(torch.sum(evals, dim=-1), 1e-12)
    return mask & (ratio < tolerance)


@torch.no_grad()
def wlop(points: torch.Tensor, mask: torch.Tensor,
         noise: Optional[torch.Tensor] = None, ratio: float = 0.5,
         neighborhood_size: int = 16, iters: int = 3,
         repulsion_mu: float = 0.5,
         generator: Optional[torch.Generator] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted locally optimal projection (points.py:51-110).

    FPS keeps `ratio` of the capacity (each cloud ceil(n·ratio) of its
    valid points), jittered by `noise`·0.1·h; then `iters` rounds move each
    seed to its data attraction (α = θ(|ε|²)/|ε| over the source's density)
    plus `repulsion_mu` times its repulsion (β = θ(|δ|²)/|δ| times its own
    density), θ(r²) = exp(−16 r²/h²), h = 4·√(diag/N).

    `noise`: standard normal draws (B, S, 3), S = ceil(P·ratio) (the JAX
    package draws them from its key); else drawn from `generator`.
    Returns (X (B, S, 3), x_mask (B, S))."""
    n_pts = torch.clamp(num_valid(mask).float(), min=1.0)
    h = 4.0 * torch.sqrt(bbox_diag(points, mask) / n_pts)              # (B,)
    theta_inv = (16.0 / eps_denom(h * h, 1e-12))[:, None, None]

    def theta(d2):
        return torch.exp(-d2 * theta_inv)

    x, x_mask, _ = fps_subsample(points, ratio, mask)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device)
    x = x + noise * (h[:, None, None] * 0.1)

    res_pp = knn_points(points, points, mask, mask, k=neighborhood_size,
                        exclude_self=True)
    density_p = torch.sum(torch.where(res_pp.mask, theta(res_pp.dists), 0.0),
                          dim=-1) + 1.0                                # (B, P)
    for _ in range(iters):
        res_xp = knn_points(x, points, x_mask, mask, k=neighborhood_size)
        res_xx = knn_points(x, x, x_mask, x_mask, k=neighborhood_size,
                            exclude_self=True)
        nn_xp = knn_gather(points, res_xp.idx)                         # (B,S,K,3)
        eps_v = x[:, :, None, :] - nn_xp
        nn_xx = knn_gather(x, res_xx.idx)
        delta = x[:, :, None, :] - nn_xx
        d_xp2 = torch.sum(eps_v * eps_v, dim=-1)
        d_xx2 = torch.sum(delta * delta, dim=-1)
        alpha = theta(d_xp2) / eps_denom(torch.sqrt(d_xp2), 1e-12)
        beta = theta(d_xx2) / eps_denom(torch.sqrt(d_xx2), 1e-12)
        density_x = torch.sum(torch.where(res_xx.mask, theta(d_xx2), 0.0),
                              dim=-1) + 1.0
        dp_at_nn = knn_gather(density_p[..., None], res_xp.idx)[..., 0]
        alpha = torch.where(res_xp.mask, alpha / eps_denom(dp_at_nn, 1e-12), 0.0)
        beta = torch.where(res_xx.mask, density_x[..., None] * beta, 0.0)
        term_data = torch.sum(alpha[..., None] * nn_xp, dim=-2) / \
            eps_denom(torch.sum(alpha, dim=-1, keepdim=True), 1e-12)
        term_repul = repulsion_mu * torch.sum(beta[..., None] * delta, dim=-2) / \
            eps_denom(torch.sum(beta, dim=-1, keepdim=True), 1e-12)
        x = torch.where(x_mask[..., None], term_data + term_repul, x)
    return x, x_mask


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


@torch.no_grad()
def resample_uniformly(points: torch.Tensor, mask: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       neighborhood_size: int = 8, shrink_ratio: float = 0.5,
                       repulsion_mu: float = 1.0,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WLOP shrink to `shrink_ratio` (k = max(neighborhood_size, 16)), then
    midpoint-upsample back to each cloud's count (points.py:238-248); the
    capacity stays. `noise`: WLOP's jitter draws (see `wlop`)."""
    n_orig = num_valid(mask)
    x, x_mask = wlop(points, mask, noise, ratio=shrink_ratio,
                     neighborhood_size=max(neighborhood_size, 16),
                     repulsion_mu=repulsion_mu, generator=generator)
    return midpoint_upsample(x, x_mask, points.shape[1], n_target=n_orig,
                             neighborhood_size=neighborhood_size)


@torch.no_grad()
def ear_lop_move(points: torch.Tensor, normals: torch.Tensor,
                 mask: torch.Tensor, neighborhood_size: int = 16,
                 repulsion_mu: float = 0.4) -> torch.Tensor:
    """EAR's anisotropic LOP move (points.py:251-287): a data term weighted
    by exp(−⟨n, p − pᵢ⟩²·σ⁻¹) (point to plane) and a density-weighted
    repulsion over the neighborhood_size + 1 nearest others, σ⁻¹ =
    N/diag, pairs past 16/σ⁻¹ cut; each move's norm clipped to the mean
    nearest-neighbour spacing. Returns the moved points (masked ones
    stay)."""
    res = knn_points(points, points, mask, mask, k=neighborhood_size + 1,
                     exclude_self=True)
    nn = knn_gather(points, res.idx)
    dists = res.dists
    n_valid = num_valid(mask).float()
    inv_sigma = (n_valid / eps_denom(bbox_diag(points, mask), 1e-12))[:, None, None]
    spatial_cut = 16.0 / torch.clamp(inv_sigma, min=1e-12)
    nn1 = torch.where(res.mask[..., 0], dists[..., 0], 0.0)
    move_clip = torch.sqrt(torch.sum(nn1, dim=-1)
                           / torch.clamp(n_valid, min=1.0))[:, None, None]
    pdiff = points[:, :, None, :] - nn
    cut = (dists > spatial_cut) | ~res.mask
    w_lop = torch.exp(-torch.sum(normals[:, :, None, :] * pdiff, dim=-1) ** 2
                      * inv_sigma)
    w_lop = torch.where(cut, 0.0, w_lop)
    spatial_w = torch.where(cut, 0.0, torch.exp(-dists * inv_sigma))
    density_w = torch.sum(spatial_w, dim=-1) + 1.0
    move_data = torch.sum(w_lop[..., None] * pdiff, dim=-2) / \
        eps_denom(torch.sum(w_lop, dim=-1, keepdim=True), 1e-12)
    move_repul = repulsion_mu * density_w[..., None] * \
        torch.sum(spatial_w[..., None] * (-pdiff), dim=-2) / \
        eps_denom(torch.sum(spatial_w, dim=-1, keepdim=True), 1e-12)

    def clip_norm(v):
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return v / torch.clamp(n, min=1e-12) * torch.minimum(n, move_clip)

    move = clip_norm(move_data) + clip_norm(move_repul)
    return torch.where(mask[..., None], points - move, points)
