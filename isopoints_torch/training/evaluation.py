"""Geometry evaluation: chamfer distances and the point-to-face distance
(port of isopoints_tpu/training/evaluation.py).

The chamfer takes its nearest neighbours from `ops/knn.knn_points` (k=1,
both directions): on CUDA tensors the kNN kernel, on CPU tensors its plain
version. The point-to-triangle distances are plain PyTorch, as they are
plain XLA in the JAX package, chunked so that a chunk holds at most
`max_pairs` (point, face) pairs.
"""

from typing import Dict, Optional

import numpy as np
import torch

from isopoints_torch.ops.knn import knn_gather, knn_points
from isopoints_torch.utils.meshing import sample_points_from_mesh


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     x_normals: Optional[torch.Tensor] = None,
                     y_normals: Optional[torch.Tensor] = None
                     ) -> Dict[str, float]:
    """Symmetric squared chamfer, and normal consistency when both normal
    sets are given (evaluation.py:20). x (N, 3), y (M, 3) on one device."""
    xb, yb = x[None], y[None]
    res_xy = knn_points(xb, yb, k=1)
    res_yx = knn_points(yb, xb, k=1)
    out = {"chamfer_p": torch.mean(res_xy.dists[..., 0])
           + torch.mean(res_yx.dists[..., 0])}
    if x_normals is not None and y_normals is not None:
        unit = lambda v: v / torch.clamp(torch.linalg.norm(v, dim=-1,
                                                           keepdim=True), min=1e-12)
        xn, yn = unit(x_normals)[None], unit(y_normals)[None]
        nn_y = knn_gather(yn, res_xy.idx)[:, :, 0]
        nn_x = knn_gather(xn, res_yx.idx)[:, :, 0]
        cos_xy = torch.abs(torch.sum(xn * nn_y, dim=-1))
        cos_yx = torch.abs(torch.sum(yn * nn_x, dim=-1))
        out["chamfer_n"] = (1.0 - torch.mean(cos_xy)) + (1.0 - torch.mean(cos_yx))
    return {k: float(v) for k, v in out.items()}


def point_tri_sq_dists(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Exact squared distances from points p (C, 3) to triangles (a, b, c),
    each (F, 3): (C, F), differentiable in p (evaluation.py:47).

    The seven edge dot products e·(p − q) are formed as p·e − q·e, each
    p·e elementwise in float32 (never on TF32 tensor cores) and q·e once a
    face, where the JAX version forms (C, F, 3) differences: they only place
    the candidates (barycentric and edge parameters, the inside test), where
    the distance is stationary, so their rounding moves a distance at second
    order. The distances are taken from the difference vectors, as in JAX."""
    ab = b - a
    ac = c - a
    bc = c - b
    lin = lambda e: (p[:, 0:1] * e[:, 0] + p[:, 1:2] * e[:, 1]
                     + p[:, 2:3] * e[:, 2])            # p·e, (C, F)
    pab, pac, pbc = lin(ab), lin(ac), lin(bc)
    qe = lambda q, e: torch.sum(q * e, -1)[None]      # (1, F)
    d1, d2 = pab - qe(a, ab), pac - qe(a, ac)         # ab·(p − a), ac·(p − a)
    d3, d4 = pab - qe(b, ab), pac - qe(b, ac)
    d5, d6 = pab - qe(c, ab), pac - qe(c, ac)
    dbc = pbc - qe(b, bc)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-20)
    v = torch.clamp(vb / denom, 0.0, 1.0)
    w = torch.clamp(vc / denom, 0.0, 1.0)
    # interior closest point
    proj_in = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]

    # edge/vertex regions via barycentric clamping of each edge
    def edge_closest(p0, e, d_num, d_den):
        t = torch.clamp(d_num / torch.clamp(d_den, min=1e-20), 0.0, 1.0)
        return p0[None] + t[..., None] * e[None]

    cand_ab = edge_closest(a, ab, d1, torch.sum(ab * ab, -1)[None])
    cand_ac = edge_closest(a, ac, d2, torch.sum(ac * ac, -1)[None])
    cand_bc = edge_closest(b, bc, dbc, torch.sum(bc * bc, -1)[None])

    # the interior candidate is valid ONLY inside the triangle
    # (independently-clamped v/w otherwise land on a fake point,
    # e.g. v=w=1 -> b+c-a); outside, the closest point is on an edge
    inside = (va >= 0) & (vb >= 0) & (vc >= 0)
    d_best = torch.sum((p[:, None] - cand_ab) ** 2, -1)
    for cand in (cand_ac, cand_bc):
        d_best = torch.minimum(d_best, torch.sum((p[:, None] - cand) ** 2, -1))
    d_in = torch.sum((p[:, None] - proj_in) ** 2, -1)
    return torch.where(inside, torch.minimum(d_best, d_in), d_best)


@torch.no_grad()
def point_face_distance(points: np.ndarray, verts: np.ndarray,
                        faces: np.ndarray, chunk: int = 4096,
                        max_pairs: int = 50_000_000, device="cuda") -> float:
    """Mean squared distance from points to the closest mesh triangle
    (evaluation.py:99), in chunks of at most `chunk` points and `max_pairs`
    (point, face) pairs, on `device`; the per-point minima come to the host
    in one copy and are summed there chunk by chunk, as in JAX."""
    dev = torch.device(device)
    chunk = max(1, min(chunk, max_pairs // max(len(faces), 1)))
    tri = torch.as_tensor(np.asarray(verts, np.float32), device=dev)[
        torch.as_tensor(np.asarray(faces, np.int64), device=dev)]   # (F, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    points = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    mins = torch.empty(len(points), dtype=torch.float32, device=dev)
    for i in range(0, len(points), chunk):
        mins[i:i + chunk] = torch.amin(
            point_tri_sq_dists(points[i:i + chunk], a, b, c), dim=1)
    mins = mins.cpu().numpy()
    total = 0.0
    for i in range(0, len(mins), chunk):
        total += mins[i:i + chunk].sum()
    return float(total / max(len(mins), 1))


def evaluate_mesh(pred_verts: np.ndarray, pred_faces: np.ndarray,
                  gt_points: np.ndarray,
                  gt_normals: Optional[np.ndarray] = None,
                  gt_verts: Optional[np.ndarray] = None,
                  gt_faces: Optional[np.ndarray] = None,
                  n_samples: int = 50_000, seed: int = 0,
                  device="cuda") -> Dict[str, float]:
    """Sample `n_samples` points of the predicted mesh; chamfer against the
    GT points, and the point-face distance (evaluation.py:127): predicted
    samples to the GT faces (`point_face`) with a GT mesh, else GT points to
    the predicted faces (`point_face_rev`, a completeness metric)."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    samples, sample_normals = sample_points_from_mesh(
        pred_verts, pred_faces, n_samples, seed=seed)
    metrics = chamfer_distance(
        t(samples), t(gt_points), x_normals=t(sample_normals),
        y_normals=None if gt_normals is None else t(gt_normals))
    if gt_verts is not None and gt_faces is not None:
        metrics["point_face"] = point_face_distance(samples, gt_verts, gt_faces,
                                                    device=dev)
    else:
        metrics["point_face_rev"] = point_face_distance(
            gt_points, pred_verts, pred_faces, device=dev)
    return metrics
