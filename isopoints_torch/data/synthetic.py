"""Synthetic MVR data (port of isopoints_tpu/data/synthetic.py: the
sphere, torus and box SDFs, `render_view`, `make_synthetic_mvr`,
`make_synthetic_dtu`, the mesh datasets `normalize_mesh`,
`render_mesh_view` and `make_mesh_mvr`, and `export_mvr_dataset`).

Views of an analytic SDF are ray-traced with the port's own ray engine and
Phong-shaded into image / mask / camera arrays, in memory or written as an
MVR or a DTU (IDR) directory. A triangle mesh is ray-cast exactly
(ops/raymesh.py, the Möller–Trumbore kernel on the card) and flat-shaded,
with dense depth and area-weighted GT surface samples. Data is made anew
from a seed on every run.
"""

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from isopoints_torch.core.camera import PerspectiveCamera, look_at_view_transform
from isopoints_torch.data.dataset import DTUDataset
from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.models.raytracing import RayTracingConfig, ray_trace
from isopoints_torch.ops.images import arange_pixels
from isopoints_torch.ops.raymesh import ray_mesh_intersect
from isopoints_torch.rendering.lighting import DirectionalLights
from isopoints_torch.rendering.texture import lighting_texture
from isopoints_torch.utils.io import save_image, save_ply
from isopoints_torch.utils.meshing import sample_points_from_mesh


def sphere_sdf(r: float = 0.5) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: torch.linalg.norm(x, dim=-1) - r


def torus_sdf(R: float = 0.4, r: float = 0.15
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A torus about the z axis, major radius R, minor radius r."""
    def f(x):
        q = torch.stack([torch.linalg.norm(x[..., :2], dim=-1) - R, x[..., 2]], -1)
        return torch.linalg.norm(q, dim=-1) - r
    return f


def box_sdf(half: float = 0.35) -> Callable[[torch.Tensor], torch.Tensor]:
    """An axis-aligned cube of half side `half`."""
    def f(x):
        q = torch.abs(x) - half
        return (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
                + torch.clamp(torch.amax(q, dim=-1), max=0.0))
    return f


SDFS = {"sphere": sphere_sdf, "torus": torus_sdf, "box": box_sdf}


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


def normalize_mesh(verts: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Centre at the bounding box midpoint and scale the largest vertex
    norm to `radius` (synthetic.py:128-136)."""
    verts = np.asarray(verts, np.float32)
    center = (verts.max(0) + verts.min(0)) / 2.0
    verts = verts - center
    scale = np.linalg.norm(verts, axis=-1).max()
    return verts * (radius / max(scale, 1e-12))


@torch.no_grad()
def render_mesh_view(verts: torch.Tensor, faces: torch.Tensor,
                     camera: PerspectiveCamera, image_size: int,
                     lights: Optional[DirectionalLights] = None,
                     base_color=(0.8, 0.5, 0.3)) -> Dict[str, np.ndarray]:
    """Ray-cast one batch of views of a triangle mesh into rgb + mask +
    depth images, flat-shaded (synthetic.py:139-170); the depth is t along
    the ray, 100 at a miss."""
    b = camera.batch_size
    dev = camera.R.device
    _, ndc = arange_pixels((image_size, image_size), b, device=dev)
    cam_pos = camera.camera_center()[:, None, :]
    _, dirs = camera.ndc_to_rays(ndc)
    res = ray_mesh_intersect(torch.broadcast_to(cam_pos, dirs.shape), dirs,
                             verts, faces)
    mask = res.hit
    lights = lights or DirectionalLights.create(device=dev)
    rgb_pts = lighting_texture(
        res.points, res.normals, lights, camera.camera_center(),
        torch.broadcast_to(torch.tensor(base_color, device=dev),
                           res.points.shape))
    rgb = torch.where(mask[..., None], torch.clamp(rgb_pts, 0.0, 1.0),
                      torch.ones_like(rgb_pts))
    depth = torch.where(mask, res.t, 100.0)
    s = image_size
    return {"img.rgb": rgb.reshape(b, s, s, 3).cpu().numpy(),
            "img.mask": mask.reshape(b, s, s, 1).float().cpu().numpy(),
            "img.depth": depth.reshape(b, s, s, 1).cpu().numpy()}


@torch.no_grad()
def make_mesh_mvr(verts: np.ndarray, faces: np.ndarray, n_views: int = 24,
                  image_size: int = 64, dist: float = 2.0, focal: float = 2.0,
                  seed: int = 0, batch: int = 4, norm_radius: float = 0.7,
                  n_gt_points: int = 20000, normalize: bool = True,
                  device="cuda") -> Dict[str, np.ndarray]:
    """In-memory MVR dataset of a triangle mesh (synthetic.py:173-229):
    the mesh normalised into the sphere of `norm_radius` (taken as it is,
    in float32, with `normalize` False), `n_views` views
    at elevations drawn from `np.random.RandomState(seed)` and evenly
    spaced azimuths, `batch` views a ray cast on `device`, GT samples with
    their face normals, and the normalised mesh."""
    verts = (normalize_mesh(verts, norm_radius) if normalize
             else np.asarray(verts, np.float32))
    faces = np.asarray(faces)
    verts_d = torch.as_tensor(verts, device=device)
    faces_d = torch.as_tensor(faces.astype(np.int64), device=device)
    rng = np.random.RandomState(seed)
    elev = rng.uniform(-45.0, 45.0, size=n_views)
    azim = np.linspace(0.0, 360.0, n_views, endpoint=False)
    rgbs, masks, depths, cam_mats = [], [], [], []
    for i in range(0, n_views, batch):
        sl = slice(i, min(i + batch, n_views))
        R, T = look_at_view_transform([dist] * (sl.stop - sl.start),
                                      elev[sl], azim[sl], device=device)
        cam = PerspectiveCamera.create(R=R, T=T, focal_length=focal,
                                       device=device)
        out = render_mesh_view(verts_d, faces_d, cam, image_size)
        rgbs.append(out["img.rgb"])
        masks.append(out["img.mask"])
        depths.append(out["img.depth"])
        for j in range(sl.stop - sl.start):
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = R[j].cpu().numpy()
            m[3, :3] = T[j].cpu().numpy()
            cam_mats.append(m)
    gt_points, gt_normals = sample_points_from_mesh(verts, faces, n_gt_points,
                                                    seed=seed)
    return {
        "img.rgb": np.concatenate(rgbs),
        "img.mask": np.concatenate(masks),
        "img.depth": np.concatenate(depths),
        "camera_mat": np.stack(cam_mats),
        "focal_length": np.asarray([focal, focal], np.float32),
        "principal_point": np.zeros(2, np.float32),
        "points": gt_points,
        "normals": gt_normals,
        "mesh_verts": verts,
        "mesh_faces": faces.astype(np.int64),
    }


@torch.no_grad()
def make_synthetic_dtu(sdf_fn: Callable, out_dir: str, n_views: int = 8,
                       image_size: int = 64, dist: float = 2.0,
                       focal_pix: Optional[float] = None, seed: int = 0,
                       scale_mat: Optional[np.ndarray] = None,
                       device="cuda") -> None:
    """Write a dataset in the IDR/DTU layout `DTUDataset` reads
    (synthetic.py:232-319): image/, mask/, cameras.npz with `world_mat_%d`
    = K[R|t] projections and `scale_mat_%d`, and points.ply.

    `scale_mat` (4, 4) is the normalized->world similarity: `world_mat_i`
    is written as P_norm @ inv(scale_mat), so the loader's world_mat @
    scale_mat recovers the normalized cameras, and the GT points are
    written in world coordinates. The images are rendered through the
    cameras `DTUDataset.camera` decomposes back out of the written
    matrices, the round trip training takes on a real scan."""
    h = w = image_size
    f = focal_pix if focal_pix is not None else image_size
    K = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]],
                 np.float32)
    rng = np.random.RandomState(seed)
    elev = rng.uniform(-30.0, 30.0, size=n_views)
    azim = np.linspace(0.0, 360.0, n_views, endpoint=False)
    R_row, T_row = (a.cpu().numpy() for a in look_at_view_transform(
        [dist] * n_views, elev, azim, device="cpu"))
    scale_mat = np.asarray(np.eye(4) if scale_mat is None else scale_mat,
                           np.float32)
    scale_inv = np.linalg.inv(scale_mat).astype(np.float32)
    cams_npz = {}
    for i in range(n_views):
        # the loader's R is column world->view and the camera takes R.T
        P = K @ np.concatenate([R_row[i].T, T_row[i][:, None]], axis=1)
        wm = np.eye(4, dtype=np.float32)
        wm[:3, :4] = P
        cams_npz[f"world_mat_{i}"] = wm @ scale_inv
        cams_npz[f"scale_mat_{i}"] = scale_mat
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    np.savez(os.path.join(out_dir, "cameras.npz"), **cams_npz)
    # placeholder images so the loader can enumerate the views
    blank = np.zeros((h, w), np.float32)
    for i in range(n_views):
        save_image(os.path.join(out_dir, "image", f"{i:06d}.png"), blank)
        save_image(os.path.join(out_dir, "mask", f"{i:06d}.png"), blank)
    ds = DTUDataset(out_dir)
    for i in range(n_views):
        out = render_view(sdf_fn, ds.camera([i], (h, w), device=device),
                          image_size)
        save_image(os.path.join(out_dir, "image", f"{i:06d}.png"),
                   out["img.rgb"][0])
        save_image(os.path.join(out_dir, "mask", f"{i:06d}.png"),
                   out["img.mask"][0][..., 0])
    init = torch.as_tensor(rng.uniform(-0.9, 0.9, (1, 4096, 3)),
                           dtype=torch.float32, device=device)
    pts, nrm, ok = _project_newton(sdf_fn, init, max_iters=30, tolerance=1e-5)
    ok = ok[0].cpu().numpy()
    # the GT scan lies in world coordinates, as a real DTU scan: the
    # similarity to the points, its rotation part to the normals
    pts_n, nrm_n = pts[0].cpu().numpy()[ok], nrm[0].cpu().numpy()[ok]
    pts_w = pts_n @ scale_mat[:3, :3].T + scale_mat[:3, 3]
    nrm_w = nrm_n @ np.linalg.inv(scale_mat[:3, :3]).astype(np.float32)
    nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-12)
    save_ply(os.path.join(out_dir, "points.ply"), pts_w, normals=nrm_w)


def export_mvr_dataset(data: Dict[str, np.ndarray], out_dir: str) -> None:
    """Write the MVRDataset directory layout (synthetic.py:322-348): image/,
    mask/[, depth/*.npy], data_dict.npz[, mesh.ply]."""
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    for i in range(data["img.rgb"].shape[0]):
        save_image(os.path.join(out_dir, "image", f"{i:05d}.png"),
                   data["img.rgb"][i])
        save_image(os.path.join(out_dir, "mask", f"{i:05d}.png"),
                   data["img.mask"][i][..., 0])
        if "img.depth" in data:
            os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
            np.save(os.path.join(out_dir, "depth", f"{i:05d}.npy"),
                    data["img.depth"][i])
    extra = {k: data[k] for k in ("points", "normals") if k in data}
    np.savez(os.path.join(out_dir, "data_dict.npz"),
             camera_mat=data["camera_mat"],
             focal_length=data["focal_length"],
             principal_point=data["principal_point"], **extra)
    if "mesh_verts" in data:
        save_ply(os.path.join(out_dir, "mesh.ply"), data["mesh_verts"],
                 faces=data["mesh_faces"])
