"""Datasets: MVR image/mask/camera directories and IDR-style DTU directories
(port of isopoints_tpu/data/dataset.py).

Host-side numpy loaders returning channels-last float32 arrays; the
training entry stacks them and stages them on the device. `camera(...)`
returns the port's `PerspectiveCamera` on the device asked for.
"""

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.logger import get_logger
from isopoints_torch.utils.io import load_image, read_ply


def decompose_camera_matrix(cam_mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(4, 4) row-vector world->view matrix -> (R (3, 3), T (3,))."""
    return cam_mat[:3, :3], cam_mat[3, :3]


def _image_files(data_dir: str, sub: str, ext: str) -> List[str]:
    return sorted(f for f in os.listdir(os.path.join(data_dir, sub))
                  if f.endswith(ext))


def _image_and_mask(data_dir: str, image_file: str, mask_file: str):
    img = load_image(os.path.join(data_dir, "image", image_file))[..., :3]
    mask = load_image(os.path.join(data_dir, "mask", mask_file))
    if mask.ndim == 3:
        mask = mask[..., 0]
    return img.astype(np.float32), (mask > 0.5).astype(np.float32)[..., None]


class MVRDataset:
    """Multiview reconstruction directory (dataset.py:30-99):
    data_dir/{image,mask[,depth]}/*.png and data_dir/data_dict.npz holding
    `camera_mat` (B, 4, 4) world->view (row vectors), `focal_length`,
    `principal_point` and optional `points`, `normals`, `colors`."""

    def __init__(self, data_dir: str, img_extension: str = "png",
                 load_dense_depth: bool = False):
        self.data_dir = data_dir
        data_dict = np.load(os.path.join(data_dir, "data_dict.npz"),
                            allow_pickle=True)
        self.camera_mat = np.asarray(data_dict["camera_mat"], np.float32)
        self.focal_length = np.asarray(
            data_dict.get("focal_length", np.array([1.0, 1.0])), np.float32)
        self.principal_point = np.asarray(
            data_dict.get("principal_point", np.array([0.0, 0.0])), np.float32)
        for k in ("points", "normals", "colors"):
            setattr(self, k, np.asarray(data_dict[k], np.float32)
                    if k in data_dict else None)
        self.image_files = _image_files(data_dir, "image", img_extension)
        self.mask_files = _image_files(data_dir, "mask", img_extension)
        if len(self.image_files) != self.camera_mat.shape[0]:
            get_logger().warning("images (%d) != cameras (%d)",
                                 len(self.image_files), self.camera_mat.shape[0])
        self.load_dense_depth = load_dense_depth

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img, mask = _image_and_mask(self.data_dir, self.image_files[idx],
                                    self.mask_files[idx])
        item = {"img.rgb": img, "img.mask": mask,
                "camera_mat": self.camera_mat[idx]}
        if self.load_dense_depth:
            stem = os.path.splitext(self.image_files[idx])[0]
            dnpy = os.path.join(self.data_dir, "depth", stem + ".npy")
            dexr = os.path.join(self.data_dir, "depth", stem + ".exr")
            if os.path.exists(dnpy):
                item["img.depth"] = np.load(dnpy).astype(np.float32)
            elif os.path.exists(dexr):
                raise ValueError(f"{dexr}: OpenEXR depth is not read by the "
                                 f"port; write depth/*.npy instead")
        return item

    def get_pointclouds(self):
        return self.points, self.normals, self.colors

    def camera(self, idx_or_indices, device=None) -> PerspectiveCamera:
        idx = np.atleast_1d(np.asarray(idx_or_indices))
        return PerspectiveCamera.create(
            R=self.camera_mat[idx][:, :3, :3], T=self.camera_mat[idx][:, 3, :3],
            focal_length=self.focal_length,
            principal_point=self.principal_point, batch_size=len(idx),
            device=device)


class DTUDataset:
    """IDR-convention DTU directory (dataset.py:102-204): data_dir/{image,
    mask}/*.png and cameras.npz with `world_mat_%d` (P = K[R|t]) and
    `scale_mat_%d`. Intrinsics and extrinsics come from the RQ
    decomposition of (world_mat @ scale_mat)[:3]."""

    def __init__(self, data_dir: str, img_extension: str = "png"):
        self.data_dir = data_dir
        cams = np.load(os.path.join(data_dir, "cameras.npz"))
        self.image_files = _image_files(data_dir, "image", img_extension)
        self.mask_files = _image_files(data_dir, "mask", img_extension)
        n = len(self.image_files)
        self.world_mats = [cams[f"world_mat_{i}"].astype(np.float32)
                           for i in range(n)]
        self.scale_mats = [cams[f"scale_mat_{i}"].astype(np.float32)
                           for i in range(n)]
        self.intrinsics, self.extrinsics = [], []
        for wm, sm in zip(self.world_mats, self.scale_mats):
            K, R, t = self._decompose_projection((wm @ sm)[:3, :4])
            self.intrinsics.append(K)
            self.extrinsics.append((R, t))

    @staticmethod
    def _decompose_projection(P: np.ndarray):
        """K, R, t of P = K[R|t] by RQ decomposition through a flipped QR,
        K with a positive diagonal and K[2, 2] = 1, det R > 0
        (dataset.py:134-154)."""
        import numpy.linalg as la
        M = P[:3, :3]
        flip = np.flipud(np.eye(3))
        q, r = la.qr(np.flipud(M).T)
        K = flip @ r.T @ flip
        R = flip @ q.T
        sgn = np.diag(np.sign(np.diag(K)))
        K = K @ sgn
        R = sgn @ R
        if la.det(R) < 0:
            R = -R
            K = -K
        t = la.inv(K) @ P[:3, 3]
        K = K / K[2, 2]
        return K.astype(np.float32), R.astype(np.float32), t.astype(np.float32)

    def get_scale_mat(self) -> np.ndarray:
        """The normalized->world similarity of the scan."""
        return self.scale_mats[0]

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img, mask = _image_and_mask(self.data_dir, self.image_files[idx],
                                    self.mask_files[idx])
        return {"img.rgb": img, "img.mask": mask, "idx": np.asarray(idx)}

    def camera(self, idx_or_indices, image_size: Tuple[int, int],
               device=None) -> PerspectiveCamera:
        """pytorch3d-convention cameras, per view: focal and principal
        point in NDC, negated (dataset.py:177-199); R the decomposed
        rotation transposed to row vectors, T = t."""
        idx = np.atleast_1d(np.asarray(idx_or_indices))
        h, w = image_size
        Rs, Ts, fls, pps = [], [], [], []
        for i in idx:
            K = self.intrinsics[i]
            R, t = self.extrinsics[i]
            fls.append([-2.0 * K[0, 0] / w, -2.0 * K[1, 1] / h])
            pps.append([-(2.0 * K[0, 2] - w) / w, -(2.0 * K[1, 2] - h) / h])
            Rs.append(R.T)
            Ts.append(t)
        return PerspectiveCamera.create(
            R=np.stack(Rs), T=np.stack(Ts),
            focal_length=np.stack(fls).astype(np.float32),
            principal_point=np.stack(pps).astype(np.float32), device=device)

    def get_gt_pointcloud(self, path: Optional[str] = None):
        path = path or os.path.join(self.data_dir, "points.ply")
        if not os.path.exists(path):
            return None
        return read_ply(path)


def batch_items(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack dataset items into batched arrays over the keys they share."""
    keys = set.intersection(*(set(i.keys()) for i in items))
    return {k: np.stack([i[k] for i in items]) for k in keys}
