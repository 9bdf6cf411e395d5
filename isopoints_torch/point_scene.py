"""The DSS point model's step as `chip_smoke.py` phase 9 and
`kernel_variants occ` drive it: isopoints_torch/configs/dss_point.yml,
5000 points on the r = 0.5 sphere (seed 5), two views at 256 px, a loss
against the render of a shifted, coloured sphere; and a recorder of the
occupancy backward's inputs in such a step."""

import os
from typing import NamedTuple

import torch

from isopoints_torch.config import load_config
from isopoints_torch.core.camera import PerspectiveCamera, look_at_view_transform
from isopoints_torch.factories import create_model
from isopoints_torch.rendering import rasterizer as rasterizer_mod


class PointScene(NamedTuple):
    """The DSS point model's step of chip_smoke.py phase 9:
    isopoints_torch/configs/dss_point.yml, 5000 points on the r = 0.5 sphere
    (seed 5), two views at 256 px, a target render of a shifted, coloured
    sphere and its mask."""
    cfg: object
    model: torch.nn.Module
    camera: PerspectiveCamera
    mask_img: torch.Tensor
    target: torch.Tensor       # (B, S, S, 4) the target render


def point_model_scene(dev) -> PointScene:
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "configs", "dss_point.yml"))
    gen = torch.Generator(device=dev).manual_seed(5)
    model = create_model(cfg, generator=gen, device=dev)
    n = model.cfg.n_points_per_cloud
    dirs = torch.randn((1, n, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    model.init(points=0.5 * dirs, normals=dirs)
    target = create_model(cfg, device=dev)
    target.init(points=0.5 * dirs + torch.tensor([0.06, -0.04, 0.0], device=dev),
                normals=dirs, colors=torch.tensor([0.8, 0.4, 0.2], device=dev
                                                  ).expand(1, n, 3))
    R, T = look_at_view_transform(2.0, [10.0, -20.0], [0.0, 120.0], device=dev)
    cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=dev)
    with torch.no_grad():
        tgt = target(cam).rgba
    return PointScene(cfg, model, cam, tgt[..., 3:], tgt)


def point_model_step(scene: PointScene, model=None):
    """One step of Σ(alpha − target)² + Σ|rgb − target_rgb|: (loss, the
    parameters' gradients, the model's output)."""
    m = scene.model if model is None else model
    m.zero_grad(set_to_none=True)
    out = m(scene.camera, mask_img=scene.mask_img)
    tgt = scene.target
    loss = (torch.sum((out.rgba[..., 3] - tgt[..., 3]) ** 2)
            + torch.sum(torch.abs(out.rgba[..., :3] - tgt[..., :3])))
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in m.named_parameters()}, out


def record_occ_calls(fn):
    """(fn(), the inputs of every occupancy backward the rasterizer's
    backward called in it, cloned)."""
    calls = []
    occ_backward = rasterizer_mod.occ_backward

    def recording(*args):
        calls.append(tuple(a.detach().clone() if torch.is_tensor(a) else a
                           for a in args))
        return occ_backward(*args)

    rasterizer_mod.occ_backward = recording
    try:
        return fn(), calls
    finally:
        rasterizer_mod.occ_backward = occ_backward
