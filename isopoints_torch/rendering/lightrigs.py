"""Light rigs oriented by the camera (port of
isopoints_tpu/rendering/lightrigs.py): `get_tri_color_lights_for_view`
(an RGB tri-light half-dome around the view axis) and `get_light_for_view`
(a white key light along the view), each as directional or point lights;
`create_animation` (saved snapshots as slider-HTML animations,
misc/visualize.py)."""

import math

import numpy as np

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.rendering.lighting import DirectionalLights, PointLights


def _to_world(d_cam: np.ndarray, camera: PerspectiveCamera) -> np.ndarray:
    """Camera-frame directions (L, 3) -> world (B, L, 3): d_cam @ R^T for
    the row-vector convention."""
    R = camera.R.detach().cpu().numpy()
    return np.einsum("ld,bdk->blk", d_cam, R.transpose(0, 2, 1))


def _rig(camera, ambient, diffuse, specular, dirs_world, point_lights):
    dev = camera.R.device
    if point_lights:
        # anchored at the scene centre, as the reference places them
        # (lightrigs.py:44-51)
        return PointLights.create(ambient_color=ambient, diffuse_color=diffuse,
                                  specular_color=specular,
                                  location=dirs_world * 5.0, device=dev)
    return DirectionalLights.create(ambient_color=ambient, diffuse_color=diffuse,
                                    specular_color=specular, direction=dirs_world,
                                    device=dev)


def get_tri_color_lights_for_view(camera: PerspectiveCamera,
                                  has_specular: bool = False,
                                  point_lights: bool = False):
    """Red, green and blue lights at elevation 30° and azimuths −60°, 60°,
    180° in the camera frame (lightrigs.py:20-53)."""
    b = camera.batch_size
    elev = math.radians(30.0)
    azims = [math.radians(a) for a in (-60.0, 60.0, 180.0)]
    dirs_cam = np.stack([[math.cos(elev) * math.sin(az), math.sin(elev),
                          -math.cos(elev) * math.cos(az)] for az in azims])
    colors = np.eye(3, dtype=np.float32)[None].repeat(b, 0)
    ambient = np.full((b, 3, 3), 0.2, np.float32)
    specular = np.full((b, 3, 3), 0.2 if has_specular else 0.0, np.float32)
    return _rig(camera, ambient, colors, specular, _to_world(dirs_cam, camera),
                point_lights)


def get_light_for_view(camera: PerspectiveCamera, has_specular: bool = True,
                       point_lights: bool = False):
    """One white key light along the view direction, 20° above it
    (lightrigs.py:56-75)."""
    b = camera.batch_size
    elev = math.radians(20.0)
    d_cam = np.asarray([[0.0, math.sin(elev), -math.cos(elev)]])
    ambient = np.full((b, 1, 3), 0.3, np.float32)
    diffuse = np.full((b, 1, 3), 0.6, np.float32)
    specular = np.full((b, 1, 3), 0.3 if has_specular else 0.0, np.float32)
    return _rig(camera, ambient, diffuse, specular, _to_world(d_cam, camera),
                point_lights)


def create_animation(pts_dir: str, show_max: int = -1) -> None:
    """Collect saved point and mesh snapshots into slider-HTML animations
    (lightrigs.py:78-107): globs `*_iso.ply` and `*_mesh.ply` under
    `pts_dir` (the last `show_max` of each when > 0) and writes
    pts_animation.html / mesh_animation.html there."""
    import glob
    import os

    from isopoints_torch.misc.visualize import animate_mesh, animate_points
    from isopoints_torch.utils.io import read_ply

    iso_files = sorted(glob.glob(os.path.join(pts_dir, "*_iso.ply")))
    if show_max > 0:
        iso_files = iso_files[-show_max:]
    if iso_files:
        animate_points([read_ply(f)["points"] for f in iso_files],
                       os.path.join(pts_dir, "pts_animation.html"),
                       names=[os.path.basename(f) for f in iso_files])
    mesh_files = sorted(glob.glob(os.path.join(pts_dir, "*_mesh.ply")))
    if show_max > 0:
        mesh_files = mesh_files[-show_max:]
    meshes = [m for m in (read_ply(f) for f in mesh_files) if "faces" in m]
    if meshes:
        animate_mesh([m["points"] for m in meshes], [m["faces"] for m in meshes],
                     os.path.join(pts_dir, "mesh_animation.html"))
