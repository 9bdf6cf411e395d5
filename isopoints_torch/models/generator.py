"""Generation: meshes and ray-traced renders of a trained model (port of
isopoints_tpu/models/generator.py).

`generate_mesh` grids the model's trace callable, the fused SIREN (or IGR)
kernel at the model's fine precision when `use_fused_mlp` is on, in one or
two stages (utils/meshing.py), optionally refining the vertices.
`raytrace_images` renders whole images in chunks of `rays_per_chunk` pixels
a view under the model's trace schedule with a floor of 20 sphere-tracing
iterations (the coarse bf16 callable and the in-kernel sampler ride along
where the config enables them), shades the hits with normals of the trace
callable, and writes the chunks into one device tensor copied to the host
once. `generate_iso_contour` writes the SDF's contours on axis-aligned
cuts as HTML (misc/visualize.plot_cuts), the values from the trace
callable.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.logger import get_logger
from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.models.implicit import ImplicitModel
from isopoints_torch.models.raytracing import RayTracingConfig, ray_trace
from isopoints_torch.ops.images import arange_pixels
from isopoints_torch.utils.meshing import extract_mesh, get_surface_high_res_mesh

@dataclass(frozen=True)
class GeneratorConfig:
    mesh_resolution: int = 256
    image_size: int = 256
    rays_per_chunk: int = 16384
    refine_steps: int = 0
    refine_lr: float = 1e-4


class Generator:
    """Mesh and image generation for an implicit or combined model."""

    def __init__(self, model: ImplicitModel, cfg: GeneratorConfig = GeneratorConfig()):
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        # rays that overflowed the trace and sampler capacities in the last
        # `raytrace_images` (they render as background)
        self.overflow = 0

    # -- meshes -----------------------------------------------------------
    def generate_mesh(self, resolution: Optional[int] = None,
                      two_stage: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """The mesh of the model's trace callable (generator.py:44)."""
        f = self.model.trace_sdf_fn()
        res = resolution or self.cfg.mesh_resolution
        if two_stage:
            verts, faces = get_surface_high_res_mesh(f, resolution=res,
                                                     device=self.device)
        else:
            verts, faces = extract_mesh(f, resolution=res, device=self.device)
        if self.cfg.refine_steps > 0 and len(verts):
            verts = self.refine_mesh(verts)
        return verts, faces

    def refine_mesh(self, verts: np.ndarray) -> np.ndarray:
        """`refine_steps` RMSprop steps on mean(sdf²) + 1e-4·mean((|∇sdf| −
        1)²) in the vertices (generator.py:58): optax.rmsprop's update,
        ν ← 0.9ν + 0.1g², v ← v − lr·g/√(ν + 1e-8), from ν = 0."""
        f = self.model.sdf_fn()
        v = torch.as_tensor(np.asarray(verts, np.float32), device=self.device)
        nu = torch.zeros_like(v)
        for _ in range(self.cfg.refine_steps):
            x = v.detach().requires_grad_(True)
            s, g = sdf_and_grad(f, x)
            loss = torch.mean(s * s) + 1e-4 * torch.mean(
                (torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
            (grad,) = torch.autograd.grad(loss, x)
            with torch.no_grad():
                nu = 0.1 * grad * grad + 0.9 * nu
                v = v + (-self.cfg.refine_lr) * (grad * torch.rsqrt(nu + 1e-8))
        return v.cpu().numpy()

    # -- normals / colors -------------------------------------------------
    @torch.no_grad()
    def estimate_normals(self, points: torch.Tensor,
                         sdf_fn: Optional[Callable] = None) -> torch.Tensor:
        """Unit SDF gradients (generator.py:81) of `sdf_fn`, by default the
        model's trace callable: the fused kernel's value+grad when
        `use_fused_mlp` is on, else autograd of the plain field."""
        _, g = sdf_and_grad(sdf_fn or self.model.trace_sdf_fn(), points)
        return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                               min=1e-12)

    @torch.no_grad()
    def estimate_colors(self, points: torch.Tensor, camera: PerspectiveCamera,
                        lights=None, sdf_fn: Optional[Callable] = None
                        ) -> torch.Tensor:
        """The model's texture at the points (generator.py:86)."""
        normals = self.estimate_normals(points, sdf_fn)
        return self.model.decode_color(points, normals, camera, lights)

    # -- images -----------------------------------------------------------
    def render_cfg(self) -> RayTracingConfig:
        """The model's trace schedule with at least 20 sphere-tracing
        iterations (generator.py:114-117)."""
        rt = self.model.raytrace_cfg
        return dataclasses.replace(
            rt, sphere_tracing_iters=max(rt.sphere_tracing_iters, 20))

    @torch.no_grad()
    def render_chunk(self, ndc: torch.Tensor, camera: PerspectiveCamera,
                     sdf_fn: Callable, sdf_fn_coarse: Optional[Callable],
                     rt_cfg: RayTracingConfig, lights=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RGBA of the rays through `ndc` (B, N, 2): background 1, RGB
        clipped to [0, 1] on hits, alpha the hit mask; and the chunk's
        overflow count (generator.py:120-131)."""
        cam_pos, dirs = camera.ndc_to_rays(ndc)
        res = ray_trace(sdf_fn, cam_pos[:, None, :], dirs,
                        torch.ones(dirs.shape[:-1], dtype=torch.bool,
                                   device=dirs.device),
                        None, rt_cfg, training=False, sdf_fn_coarse=sdf_fn_coarse)
        rgb = self.estimate_colors(res.points, camera, lights, sdf_fn)
        hit = res.network_object_mask
        rgb = torch.where(hit[..., None], torch.clamp(rgb, 0.0, 1.0), 1.0)
        rgba = torch.cat([rgb, hit[..., None].float()], dim=-1)
        return rgba, res.trace_overflow + res.sampler_overflow

    @torch.no_grad()
    def raytrace_images(self, camera: PerspectiveCamera, lights=None,
                        image_size: Optional[int] = None) -> np.ndarray:
        """Full RGBA renders (B, S, S, 4) by chunked ray tracing
        (generator.py:93). The last chunk is padded with rays through the
        image centre, traced and dropped."""
        s = image_size or self.cfg.image_size
        b = camera.batch_size
        f = self.model.trace_sdf_fn()
        f_coarse = self.model.trace_sdf_fn_coarse()
        rt_cfg = self.render_cfg()
        _, ndc_full = arange_pixels((s, s), b, device=self.device)
        chunk = self.cfg.rays_per_chunk
        n_total = s * s
        pad = (-n_total) % chunk
        ndc_pad = torch.nn.functional.pad(ndc_full, (0, 0, 0, pad))
        out = torch.empty((b, n_total + pad, 4), dtype=torch.float32,
                          device=self.device)
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, n_total + pad, chunk):
            out[:, i:i + chunk], ovf = self.render_chunk(
                ndc_pad[:, i:i + chunk], camera, f, f_coarse, rt_cfg, lights)
            overflow += ovf
        self.overflow = int(overflow)
        if self.overflow:
            # the inherited training capacities were tuned on a random-pixel
            # ray mix; a silhouette-heavy full-image chunk can exceed them
            get_logger().warning(
                "raytrace_images: %d rays overflowed the trace/sampler "
                "capacities and rendered as background — raise raytrace "
                "sampler_fraction / compaction fractions for rendering-quality "
                "output", self.overflow)
        return out[:, :n_total].cpu().numpy().reshape(b, s, s, 4)

    # -- contours ---------------------------------------------------------
    def generate_iso_contour(self, filename: str, **kwargs) -> None:
        """Contours of the model's SDF on axis-aligned cuts into `filename`
        (generator.py:156-160 -> plot_cuts; `kwargs` are plot_cuts'), each
        cut evaluated by the trace callable on the model's device: the fused
        MLP kernel at the fine precision when `use_fused_mlp` is on."""
        from isopoints_torch.misc.visualize import plot_cuts

        plot_cuts(self.model.trace_sdf_fn(), filename, device=self.device,
                  **kwargs)
