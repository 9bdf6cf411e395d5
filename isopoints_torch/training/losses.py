"""Loss zoo (port of isopoints_tpu/training/losses.py): the regressions,
the SDF losses (eikonal, BCE freespace / occupancy, the SAL / SALD space
losses), the mask IoU, the RIMLS projection and repulsion regularizers of
the DSS point model, and the mesh-supervised signed distance.

The RIMLS losses take their neighbours from `knn_points` (the kNN kernel on
CUDA tensors, k = knn_k = 32 by default) and record dL/dpoints under the
debug taps "proj" and "repel". `signed_distance_loss` is plain PyTorch, as
the JAX loss is XLA: no kernel computes it.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from isopoints_torch.debug import tap_grad
from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.utils import eps_denom, eps_sqrt, num_valid


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


# --- basic regressions (losses.py:38-61) -------------------------------------

def _channels_summed(x: torch.Tensor, mask) -> bool:
    """Whether x carries a channel axis past the mask's (losses.py:38-47)."""
    return x.dim() > (mask.dim() if mask is not None else x.dim() - 1)


def l1_loss(pred, target, mask=None, reduction: str = "mean"):
    """|pred − target|, summed over channels when x has one past the mask."""
    d = torch.abs(pred - target)
    return reduce_loss(torch.sum(d, dim=-1) if _channels_summed(d, mask) else d,
                       mask, reduction)


def l2_loss(pred, target, mask=None, reduction: str = "mean"):
    """(pred − target)², summed over channels as `l1_loss`."""
    d = pred - target
    return reduce_loss(torch.sum(d * d, dim=-1) if _channels_summed(d, mask)
                       else d * d, mask, reduction)


def smape_loss(pred, target, mask=None, reduction: str = "mean",
               eps: float = 1e-8):
    """Symmetric mean absolute percentage |p − t| / (|p| + |t| + eps),
    averaged over channels past the mask's axes."""
    d = torch.abs(pred - target) / (torch.abs(pred) + torch.abs(target) + eps)
    if d.dim() > (mask.dim() if mask is not None else d.dim()):
        d = torch.mean(d, dim=-1)
    return reduce_loss(d, mask, reduction)


# --- SDF losses ----------------------------------------------------------------

def eikonal_loss(grad: torch.Tensor, mask=None, reduction: str = "mean"):
    """(|∇f| − 1)² (NormalLengthLoss)."""
    n = torch.linalg.norm(grad, dim=-1)
    return reduce_loss((n - 1.0) ** 2, mask, reduction)


def normal_cos_loss(pred_normals, gt_normals, mask=None,
                    reduction: str = "mean", absolute: bool = True):
    """1 − |cos(n_pred, n_gt)| (1 − cos with `absolute=False`)
    (losses.py:66-77)."""
    a = pred_normals / torch.clamp(torch.linalg.norm(pred_normals, dim=-1,
                                                     keepdim=True), min=1e-12)
    b = gt_normals / torch.clamp(torch.linalg.norm(gt_normals, dim=-1,
                                                   keepdim=True), min=1e-12)
    cos = torch.sum(a * b, dim=-1)
    if absolute:
        cos = torch.abs(cos)
    return reduce_loss(1.0 - cos, mask, reduction)


def sdf_freespace_loss(sdf: torch.Tensor, alpha: float = 1.0, mask=None,
                       reduction: str = "sum"):
    """BCE(−α·sdf, 0): freespace points must have positive sdf."""
    return reduce_loss(F.softplus(-alpha * sdf), mask, reduction)


def sdf_occupancy_loss(sdf: torch.Tensor, alpha: float = 1.0, mask=None,
                       reduction: str = "sum"):
    """BCE(−α·sdf, 1): occupied points must have negative sdf."""
    return reduce_loss(F.softplus(alpha * sdf), mask, reduction)


def sal_space_loss(sdf: torch.Tensor, dist_to_cloud: torch.Tensor, mask=None,
                   reduction: str = "mean"):
    """SAL's unsigned-distance match (√d_nn − |f|)² (losses.py:95-100)."""
    return reduce_loss((torch.sqrt(eps_sqrt(dist_to_cloud)) - torch.abs(sdf)) ** 2,
                       mask, reduction)


def exp_space_loss(sdf: torch.Tensor, alpha: float = 100.0, mask=None,
                   reduction: str = "mean"):
    """IGR's off-surface term exp(−α|f|) (losses.py:103-107)."""
    return reduce_loss(torch.exp(-alpha * torch.abs(sdf)), mask, reduction)


def sald_offnormal_loss(grad: torch.Tensor, gt_normals: torch.Tensor,
                        mask=None, reduction: str = "mean"):
    """SALD's min(|∇f − n|, |∇f + n|)² (losses.py:110-116)."""
    d1 = torch.sum((grad - gt_normals) ** 2, dim=-1)
    d2 = torch.sum((grad + gt_normals) ** 2, dim=-1)
    return reduce_loss(torch.minimum(d1, d2), mask, reduction)


def iou_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean"):
    """Negative intersection over union per item (losses.py:119-124)."""
    dims = tuple(range(1, pred.dim()))
    inter = torch.sum(pred * target, dim=dims)
    union = torch.sum(pred + target - pred * target, dim=dims)
    return reduce_loss(-inter / eps_denom(union, 1e-12), reduction=reduction)


# --- RIMLS surface losses (losses.py:129-206) ----------------------------------

def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
def _rimls_weights(points, normals, mask, knn_k: int = 32,
                   filter_scale: float = 2.0, sharpness_sigma: float = 0.75):
    """The weights both RIMLS losses share (losses.py:129-163): the low pass
    phi = (1 − d²/s)⁴ with s = 2·d₁²·scale², normals mollified twice
    (phi, then phi times the bilateral normal weight), and the cutoff
    d² > scale·2·d₁². Returns (kNN result, neighbours, mollified normals,
    normal weights, weights, cutoff)."""
    res = knn_points(points, points, mask, mask, k=knn_k, exclude_self=True)
    nn = knn_gather(points, res.idx)
    d2 = res.dists
    spacing = d2[:, :, :1] * 2.0      # local point spacing² = 2·d(nn1)²
    s = spacing * filter_scale * filter_scale
    phi = torch.clamp(1.0 - d2 / eps_denom(s, 1e-12), min=0.0)
    phi = (phi * phi) ** 2
    phi = torch.where(res.mask, phi, 0.0)

    def denoise(nrm, w):
        knn_n = knn_gather(nrm, res.idx)
        return torch.sum(knn_n * w[..., None], dim=-2) / \
            eps_denom(torch.sum(w, dim=-1, keepdim=True), 1e-12)

    normals = denoise(normals, phi)
    inv_sig_n = 1.0 / (sharpness_sigma * sharpness_sigma)
    knn_n = knn_gather(_unit(normals), res.idx)
    dn = knn_n - _unit(normals)[:, :, None, :]
    normal_w = torch.exp(-torch.sum(dn * dn, dim=-1) * inv_sig_n)
    normals = denoise(normals, phi * normal_w)
    ball = d2 > (filter_scale * spacing)
    weights = torch.where(ball | ~res.mask, 0.0, phi * normal_w)
    return res, nn, normals, normal_w, weights, ball


def projection_loss(points, normals, mask, knn_k: int = 32,
                    filter_scale: float = 2.0, sharpness_sigma: float = 0.75,
                    reduction: str = "mean"):
    """RIMLS weighted point-to-plane distance² (ProjectionLoss,
    losses.py:166-178); the gradient reaches `points` only."""
    res, nn, nrm_dn, _, weights, _ = _rimls_weights(
        points.detach(), normals.detach(), mask, knn_k, filter_scale,
        sharpness_sigma)
    knn_n = knn_gather(nrm_dn, res.idx)
    points = tap_grad("proj", points)
    dist = torch.sum((nn - points[:, :, None, :]) * knn_n, dim=-1)
    d = torch.sum(weights * dist, dim=-1) / eps_denom(torch.sum(weights, dim=-1),
                                                      1e-12)
    return reduce_loss(d * d, mask, reduction)


def repulsion_loss(points, normals, mask, knn_k: int = 32,
                   filter_scale: float = 2.0, sharpness_sigma: float = 0.75,
                   reduction: str = "mean"):
    """The weighted point-to-point distances after the projection onto the
    local planes, negated (RepulsionLoss, losses.py:181-206)."""
    res, nn, nrm_dn, normal_w, weights, ball = _rimls_weights(
        points.detach(), normals.detach(), mask, knn_k, filter_scale,
        sharpness_sigma)
    knn_n = knn_gather(nrm_dn, res.idx)
    points = tap_grad("repel", points)
    dist_plane = torch.sum((nn - points[:, :, None, :]) * knn_n, dim=-1)
    deltap = torch.sum(dist_plane[..., None] * weights[..., None] * knn_n, dim=-2) / \
        eps_denom(torch.sum(weights, dim=-1, keepdim=True), 1e-12)
    proj = points + deltap
    inv_sigma_sp = (2.0 / torch.clamp(num_valid(mask).float(), min=1.0))[:, None, None]
    dd = nn - proj.detach()[:, :, None, :]
    spatial_w = torch.exp(-torch.sum(dd * dd, dim=-1) / eps_denom(inv_sigma_sp, 1e-12))
    density_w = torch.sum(spatial_w, dim=-1, keepdim=True) + 1.0
    w = torch.where(ball | ~res.mask, 0.0, normal_w * spatial_w * density_w)
    diff = proj[:, :, None, :] - nn
    p2p = torch.sum(diff * diff, dim=-1)
    loss = -torch.sum(p2p * w, dim=(-1, -2)) / eps_denom(torch.sum(w, dim=(-1, -2)),
                                                         1e-12)
    return reduce_loss(loss, reduction=reduction)


# --- mesh-supervised signed distance (losses.py:209-296) -----------------------

_SDL_ANCHORS = ((2.17, 1.83, 2.41), (1.79, 2.31, 1.97), (2.43, 2.09, 1.73))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


@torch.no_grad()
def _mesh_sign_and_face(pts: torch.Tensor, tri: torch.Tensor, verts: torch.Tensor,
                        anchors: Tuple, face_chunk: int):
    """The face-chunked scan of `signed_distance_loss` (losses.py:248-292):
    each point's nearest face (the first of equal distances) and its sign
    (−1 inside by the anchors' majority vote, else 1)."""
    from isopoints_torch.training.evaluation import point_tri_sq_dists

    f_total = tri.shape[0]
    fc = min(face_chunk, f_total)
    anch = torch.tensor(anchors, dtype=torch.float32, device=pts.device)
    vmax = torch.amax(torch.linalg.norm(verts.float(), dim=-1))
    amin = torch.amin(torch.linalg.norm(anch, dim=-1))
    anch = anch * torch.clamp(1.25 * vmax / amin, min=1.0)
    seg = anch[:, None, :] - pts[None]                            # (A, P, 3)
    cnt = torch.zeros((anch.shape[0], pts.shape[0]), dtype=torch.long,
                      device=pts.device)
    dmin = torch.full((pts.shape[0],), float("inf"), device=pts.device)
    face = torch.zeros(pts.shape[0], dtype=torch.long, device=pts.device)
    for base in range(0, f_total, fc):
        tri_k = tri[base:base + fc]
        av, bv, cv = tri_k[:, 0], tri_k[:, 1], tri_k[:, 2]
        cmin, carg = torch.min(point_tri_sq_dists(pts, av, bv, cv), dim=-1)
        better = cmin < dmin          # strict: the first face keeps a tie
        dmin = torch.where(better, cmin, dmin)
        face = torch.where(better, base + carg, face)
        # Möller–Trumbore crossings of the segments point -> anchor
        e1 = bv - av
        e2 = cv - av
        pvec = _cross(seg[..., None, :], e2[None, None])          # (A, P, fc, 3)
        det = torch.sum(e1[None, None] * pvec, dim=-1)
        ok_det = torch.abs(det) > 1e-9
        inv = torch.where(ok_det, 1.0 / det, 0.0)
        tvec = pts[None, :, None, :] - av[None, None]
        u = torch.sum(tvec * pvec, dim=-1) * inv
        qvec = _cross(tvec, e1[None, None])
        v = torch.sum(seg[..., None, :] * qvec, dim=-1) * inv
        t = torch.sum(e2[None, None] * qvec, dim=-1) * inv
        eps = 1e-7
        ok = (ok_det & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
              & (t > 1e-6) & (t <= 1.0))
        cnt = cnt + torch.sum(ok.long(), dim=-1)
    inside_votes = torch.sum((cnt % 2 == 1).long(), dim=0)
    sign = torch.where(inside_votes * 2 > anch.shape[0], -1.0, 1.0)
    return sign, face


def mesh_signed_distance(points: torch.Tensor, verts: torch.Tensor,
                         faces: torch.Tensor, anchors: Tuple = _SDL_ANCHORS,
                         face_chunk: int = 2048) -> torch.Tensor:
    """The signed distance `signed_distance_loss` holds `sdf` to: (P,),
    negative inside the mesh, differentiable in the points and verts."""
    from isopoints_torch.training.evaluation import point_tri_sq_dists

    pts = points.float()
    tri = verts.float()[faces.long()]                    # (F, 3, 3)
    sign, face = _mesh_sign_and_face(pts.detach(), tri.detach(), verts.detach(),
                                     anchors, face_chunk)
    # the nearest face's distance again, with autograd, in blocks of points
    near = tri[face]                                     # (P, 3, 3)
    blk = 256
    d2 = torch.cat([torch.diagonal(point_tri_sq_dists(
        pts[i:i + blk], near[i:i + blk, 0], near[i:i + blk, 1],
        near[i:i + blk, 2])) for i in range(0, pts.shape[0], blk)])
    return sign * torch.sqrt(eps_sqrt(d2))


def signed_distance_loss(points: torch.Tensor, sdf: torch.Tensor,
                         verts: torch.Tensor, faces: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         reduction: str = "mean",
                         anchors: Tuple = _SDL_ANCHORS,
                         face_chunk: int = 2048) -> torch.Tensor:
    """(sign·dist − sdf)² against a mesh's signed distance
    (SignedDistanceLoss, losses.py:211-296). points (P, 3), sdf (P,),
    verts (V, 3), faces (F, 3) int.

    The faces are scanned in chunks of `face_chunk`, as in the JAX loss:
    each chunk's exact point-triangle distances (`point_tri_sq_dists`) keep
    each point's nearest face, and its Möller–Trumbore crossings of the
    segment point → anchor (t in (1e-6, 1], the three anchors scaled out
    radially past 1.25 × the mesh's radius when they do not clear it)
    count the parity; the sign is the majority of the three anchors' votes
    and carries no gradient. The scan runs without autograd, so no chunk's
    (P, F) pairs stay for the backward: the distance to each point's nearest
    face is then formed again with autograd, the same float operations on
    the same pair (the gradient of a minimum is that of its minimiser's
    term), and reaches `sdf`, `points` and `verts`."""
    dist = mesh_signed_distance(points, verts, faces, anchors, face_chunk)
    return reduce_loss((dist - sdf) ** 2, mask, reduction)
