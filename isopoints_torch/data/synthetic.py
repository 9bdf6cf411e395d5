"""Synthetic MVR data (port of isopoints_tpu/data/synthetic.py:
`sphere_sdf`, `render_view`, `make_synthetic_mvr`).

Views of an analytic SDF are ray-traced with the port's own ray engine and
Phong-shaded into image / mask / camera arrays; data is made anew from a
seed on every run.
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from isopoints_torch.core.camera import PerspectiveCamera, look_at_view_transform
from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.models.raytracing import RayTracingConfig, ray_trace
from isopoints_torch.ops.images import arange_pixels
from isopoints_torch.rendering.lighting import DirectionalLights
from isopoints_torch.rendering.texture import lighting_texture


def sphere_sdf(r: float = 0.5) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: torch.linalg.norm(x, dim=-1) - r


@torch.no_grad()
def render_view(sdf_fn: Callable, camera: PerspectiveCamera, image_size: int,
                lights: Optional[DirectionalLights] = None,
                base_color=(0.8, 0.5, 0.3)) -> Dict[str, np.ndarray]:
    """Ray-trace one batch of views into rgb + mask images."""
    b = camera.batch_size
    dev = camera.R.device
    _, ndc = arange_pixels((image_size, image_size), b, device=dev)
    cam_pos = camera.camera_center()[:, None, :]
    _, dirs = camera.ndc_to_rays(ndc)
    res = ray_trace(sdf_fn, cam_pos, dirs,
                    torch.ones(dirs.shape[:-1], dtype=torch.bool, device=dev),
                    None, RayTracingConfig(sphere_tracing_iters=30),
                    training=False)
    mask = res.network_object_mask
    _, grads = sdf_and_grad(sdf_fn, res.points)
    normals = grads / torch.clamp(torch.linalg.norm(grads, dim=-1, keepdim=True),
                                  min=1e-12)
    lights = lights or DirectionalLights.create(device=dev)
    rgb_pts = lighting_texture(
        res.points, normals, lights, camera.camera_center(),
        torch.broadcast_to(torch.tensor(base_color, device=dev),
                           res.points.shape))
    rgb = torch.where(mask[..., None], torch.clamp(rgb_pts, 0.0, 1.0),
                      torch.ones_like(rgb_pts))
    s = image_size
    return {"img.rgb": rgb.reshape(b, s, s, 3).cpu().numpy(),
            "img.mask": mask.reshape(b, s, s, 1).float().cpu().numpy()}


def _project_newton(sdf_fn: Callable, pts: torch.Tensor, max_iters: int,
                    tolerance: float, step_clip: float = 0.1):
    """Masked Newton projection onto the zero level set (the loop of
    isopoints_tpu/models/levelset.py:66-134, for the GT samples)."""
    sdf, grad = sdf_and_grad(sdf_fn, pts)
    for _ in range(max_iters):
        active = sdf.abs() > tolerance
        if not bool(active.any()):
            break
        ssg = torch.sum(grad * grad, dim=-1, keepdim=True)
        move = sdf[..., None] * grad / torch.clamp(ssg, min=1e-17)
        mnorm = torch.linalg.norm(move, dim=-1, keepdim=True)
        move = move / torch.clamp(mnorm, min=1e-15) * torch.clamp(mnorm, max=step_clip)
        move = torch.where(torch.isfinite(move), move, torch.zeros_like(move))
        pts = torch.where(active[..., None], pts - move, pts)
        sdf, grad = sdf_and_grad(sdf_fn, pts)
    return pts, grad, sdf.abs() <= tolerance


@torch.no_grad()
def make_synthetic_mvr(sdf_fn: Callable, n_views: int = 24,
                       image_size: int = 64, dist: float = 2.0,
                       focal: float = 2.0, seed: int = 0, batch: int = 8,
                       device="cuda") -> Dict[str, np.ndarray]:
    """In-memory MVR dataset: images, masks, camera matrices, GT surface
    samples (synthetic.py:80-125)."""
    rng = np.random.RandomState(seed)
    elev = rng.uniform(-45.0, 45.0, size=n_views)
    azim = np.linspace(0.0, 360.0, n_views, endpoint=False)
    rgbs, masks, cam_mats = [], [], []
    for i in range(0, n_views, batch):
        sl = slice(i, min(i + batch, n_views))
        R, T = look_at_view_transform([dist] * (sl.stop - sl.start),
                                      elev[sl], azim[sl], device=device)
        cam = PerspectiveCamera.create(R=R, T=T, focal_length=focal,
                                       device=device)
        out = render_view(sdf_fn, cam, image_size)
        rgbs.append(out["img.rgb"])
        masks.append(out["img.mask"])
        for j in range(sl.stop - sl.start):
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = R[j].cpu().numpy()
            m[3, :3] = T[j].cpu().numpy()
            cam_mats.append(m)
    init = torch.as_tensor(rng.uniform(-0.9, 0.9, (1, 8192, 3)),
                           dtype=torch.float32, device=device)
    pts, nrm, ok = _project_newton(sdf_fn, init, max_iters=30, tolerance=1e-5)
    ok = ok[0].cpu().numpy()
    gt_points = pts[0].cpu().numpy()[ok]
    gt_normals = nrm[0].cpu().numpy()[ok]
    gt_normals = gt_normals / np.maximum(
        np.linalg.norm(gt_normals, axis=-1, keepdims=True), 1e-12)
    return {
        "img.rgb": np.concatenate(rgbs),
        "img.mask": np.concatenate(masks),
        "camera_mat": np.stack(cam_mats),
        "focal_length": np.asarray([focal, focal], np.float32),
        "principal_point": np.zeros(2, np.float32),
        "points": gt_points.astype(np.float32),
        "normals": gt_normals.astype(np.float32),
    }
