"""IDR ray tracing (port of isopoints_tpu/models/raytracing.py).

Full-width over a static (B, N) ray grid with masks, as in the JAX
package: bounding-sphere interval -> bidirectional sphere tracing with
the line-search backstep -> dense sampler + secant for unconverged rays
-> (training) random-stratified min-SDF points for mask-loss pixels.

With a fused SDF callable (ops/fused_mlp.py) the sphere trace evaluates
the fused MLP kernel and, with `sampler_in_kernel`, the dense sampler and
the min-SDF sweep run in the fused sampler kernel (ops/fused_sampler.py).

`RayTracingConfig` keeps every field of the JAX config. The production
trace schedule (coarse bf16 phase, compaction, fused backstep, coarse or
presweep sampler, in-kernel march, end-front gating, sampler_fraction < 1)
is not ported yet: those values raise NotImplementedError. The plain
sweep and the secant (`_secant_scan` in the JAX module) live in
ops/fused_sampler.py beside the kernel they are the twin of.
"""

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from isopoints_torch.ops.fused_sampler import sweep_plain
from isopoints_torch.utils import eps_denom, fma, linspace01

SDFFn = Callable[[torch.Tensor], torch.Tensor]  # (..., 3) -> (...)

_SLICE2 = ("is not ported yet: ROADMAP 'Slices of the port' 2, the "
           "production trace schedule")


def intersection_with_unit_sphere(cam_pos: torch.Tensor, rays: torch.Tensor,
                                  radius: float = 1.0
                                  ) -> Tuple[torch.Tensor, ...]:
    """Near/far intersections with a centered sphere; misses fall back to
    the tangent-plane intersection (raytracing.py:82-114).
    Returns (near (..., 3), far (..., 3), hit (...))."""
    p = torch.broadcast_to(cam_pos, rays.shape)
    q = rays
    ptq = torch.sum(p * q, dim=-1)
    mid = fma(-ptq[..., None], q, p)
    dist = torch.linalg.norm(mid, dim=-1)
    cam_dist = torch.linalg.norm(p, dim=-1)
    hit = dist <= radius
    zero = torch.zeros_like(dist)
    half_chord = torch.sqrt(torch.maximum(radius * radius - dist * dist, zero))
    chord = torch.where(hit, 2.0 * half_chord, torch.full_like(dist, 10.0))
    z_near_hit = torch.sqrt(torch.maximum(cam_dist * cam_dist - dist * dist,
                                          zero)) - half_chord
    cos_view = eps_denom(-ptq / torch.clamp(cam_dist, min=1e-12))
    z_near = torch.where(hit, z_near_hit, (cam_dist - radius) / cos_view)
    z_far_miss = (cam_dist + radius) / cos_view
    near = fma(z_near[..., None], q, p)
    far = torch.where(hit[..., None], fma(chord[..., None], q, near),
                      fma(z_far_miss[..., None], q, p))
    return near, far, hit


@dataclass(frozen=True)
class RayTracingConfig:
    """Every knob of the JAX RayTracingConfig (raytracing.py:182-333);
    see there for their semantics."""
    object_bounding_sphere: float = 1.0
    sdf_threshold: float = 5e-5
    line_search_step: float = 0.5
    line_step_iters: int = 1
    sphere_tracing_iters: int = 10
    n_steps: int = 100
    n_secant_steps: int = 8
    sampler_chunk_rays: int = 0
    sampler_fraction: float = 1.0
    trace_compact_after: Union[int, Tuple[int, ...]] = 0
    trace_compact_fraction: Union[float, Tuple[float, ...]] = 0.25
    coarse_trace_iters: int = 0
    sampler_coarse: bool = False
    sampler_coarse_margin: float = 0.0
    fused_backstep: bool = False
    coarse_stall_on_cross: bool = False
    trace_compact_coarse: bool = False
    sampler_presweep: int = 0
    sampler_presweep_lipschitz: float = 2.0
    sampler_dense_fraction: float = 0.5
    trace_in_kernel: bool = False
    sampler_in_kernel: bool = False
    trace_gate_end_front: bool = False

    def __post_init__(self):
        stages = self.trace_compact_after
        stages = (stages,) if isinstance(stages, int) else tuple(stages)
        unported = {
            "coarse_trace_iters > 0": self.coarse_trace_iters > 0,
            "trace_compact_after": any(0 < a < self.sphere_tracing_iters
                                       for a in stages),
            "fused_backstep": self.fused_backstep,
            "sampler_coarse": self.sampler_coarse,
            "sampler_presweep": 2 <= self.sampler_presweep < self.n_steps,
            "trace_in_kernel": self.trace_in_kernel,
            "sampler_fraction < 1": self.sampler_fraction < 1.0,
            "trace_gate_end_front": self.trace_gate_end_front,
        }
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"RayTracingConfig {name} {_SLICE2}")


class RayTraceResult(NamedTuple):
    points: torch.Tensor               # (B, N, 3) surface / fallback points
    dists: torch.Tensor                # (B, N) ray lengths
    network_object_mask: torch.Tensor  # (B, N) ray hits the implicit surface
    mask_intersect: torch.Tensor       # (B, N) ray intersects bounding sphere
    sampler_mask: torch.Tensor         # (B, N) handled by the dense sampler
    trace_overflow: torch.Tensor       # scalar int32 compaction overflow (0)
    sampler_overflow: torch.Tensor     # scalar int32 sampler overflow (0)


def _bidirectional_sphere_trace(sdf_fn: SDFFn, cam_loc, ray_dirs,
                                mask_intersect, t_near, t_far,
                                cfg: RayTracingConfig):
    """March the start (+) and end (−) fronts until both stall or cross,
    with the in-iteration line-search backstep on a crossing
    (the reference `body` of raytracing.py:469-553).
    Returns (acc_s, acc_e, unfinished_start, overflow=0)."""
    thr = cfg.sdf_threshold

    def eval_pair(ts, te):
        # both fronts in one batched eval (one kernel launch)
        both = sdf_fn(torch.cat([fma(ts[..., None], ray_dirs, cam_loc),
                                 fma(te[..., None], ray_dirs, cam_loc)],
                                dim=-2))
        n = ts.shape[-1]
        return both[..., :n], both[..., n:]

    zero = torch.zeros_like(t_near)
    sdf_s, sdf_e = eval_pair(t_near, t_far)
    sdf_s = torch.where(mask_intersect, sdf_s, zero)
    sdf_e = torch.where(mask_intersect, sdf_e, zero)
    un_s = mask_intersect & (sdf_s > thr)
    un_e = mask_intersect & (sdf_e > thr)
    acc_s, acc_e = t_near, t_far
    for _ in range(cfg.sphere_tracing_iters):
        if not bool((un_s | un_e).any()):
            break
        cur_s = torch.where(un_s & (sdf_s > thr), sdf_s, zero)
        cur_e = torch.where(un_e & (sdf_e > thr), sdf_e, zero)
        acc_s = acc_s + cur_s
        acc_e = acc_e - cur_e
        new_s, new_e = eval_pair(acc_s, acc_e)
        for i in range(cfg.line_step_iters):
            scale = (1.0 - cfg.line_search_step) / (2.0 ** i)
            bs = un_s & (new_s < 0)
            be = un_e & (new_e < 0)
            acc_s = torch.where(bs, fma(torch.full_like(cur_s, -scale), cur_s,
                                        acc_s), acc_s)
            acc_e = torch.where(be, fma(torch.full_like(cur_e, scale), cur_e,
                                        acc_e), acc_e)
            ev_s, ev_e = eval_pair(acc_s, acc_e)
            new_s = torch.where(bs, ev_s, new_s)
            new_e = torch.where(be, ev_e, new_e)
        not_crossed = acc_s < acc_e
        un_s = un_s & (new_s > thr) & not_crossed
        un_e = un_e & (new_e > thr) & not_crossed
        sdf_s, sdf_e = new_s, new_e
    overflow = torch.zeros((), dtype=torch.int32, device=t_near.device)
    return acc_s, acc_e, un_s, overflow


def _dense_ray_sampler(sdf_fn: SDFFn, cam_loc, ray_dirs, object_mask, t_lo,
                       t_hi, sampler_mask, cfg: RayTracingConfig,
                       training: bool):
    """Uniform n_steps sweep + first-sign-change pick + secant
    (raytracing.py:800-888, fine sweep). In the fused kernel when
    `sampler_in_kernel` and `sdf_fn` carries `.fused_ray_sampler`, else
    the plain sweep. Returns (points, t, object_mask, overflow=0)."""
    steps = linspace01(cfg.n_steps, device=ray_dirs.device)
    fused = getattr(sdf_fn, "fused_ray_sampler", None)
    if cfg.sampler_in_kernel and fused is not None:
        t_pick, f_pick, t_min, z_secant = fused(
            cam_loc, ray_dirs, t_lo, t_hi, steps,
            n_secant=cfg.n_secant_steps, margin=0.0, coarse_sweep=False)
    else:
        t_pick, f_pick, t_min, z_secant = sweep_plain(
            sdf_fn, cam_loc, ray_dirs, t_lo, t_hi, steps,
            cfg.n_secant_steps, 0.0, cfg.sampler_chunk_rays)
    net_surface = f_pick < 0
    secant_ok = net_surface & (object_mask if training
                               else torch.ones_like(net_surface))
    p_out = ~(object_mask & net_surface)
    t_out = torch.where(secant_ok, z_secant,
                        torch.where(p_out, t_min, t_pick))
    pts_out = fma(t_out[..., None], ray_dirs, cam_loc)
    overflow = torch.zeros((), dtype=torch.int32, device=t_lo.device)
    return pts_out, t_out, sampler_mask & net_surface, overflow


def _minimal_sdf_points(sdf_fn: SDFFn, u: torch.Tensor, cam_loc, ray_dirs,
                        t_lo, t_hi, chunk_rays: int = 0,
                        in_kernel: bool = False):
    """Min-SDF point per ray over the random step fractions `u`
    (raytracing.py:953-971; JAX draws u = uniform(key, (n_steps,)))."""
    fused = getattr(sdf_fn, "fused_ray_sampler", None)
    if in_kernel and fused is not None:
        _, _, t_min, _ = fused(cam_loc, ray_dirs, t_lo, t_hi, u, n_secant=0,
                               margin=0.0, coarse_sweep=False)
    else:
        _, _, t_min, _ = sweep_plain(sdf_fn, cam_loc, ray_dirs, t_lo, t_hi,
                                     u, 0, 0.0, chunk_rays)
    return fma(t_min[..., None], ray_dirs, cam_loc), t_min


def ray_trace(sdf_fn: SDFFn, cam_loc: torch.Tensor, ray_dirs: torch.Tensor,
              object_mask: torch.Tensor, u: Optional[torch.Tensor] = None,
              cfg: RayTracingConfig = RayTracingConfig(),
              training: bool = True) -> RayTraceResult:
    """Full IDR ray tracing (raytracing.py:974-1067, sampler_fraction >= 1).

    Args:
      cam_loc: (B, 1, 3) or (B, N, 3) camera centers.
      ray_dirs: (B, N, 3) unit directions.
      object_mask: (B, N) GT silhouette at each ray's pixel.
      u: (n_steps,) min-SDF step fractions in [0, 1); required when
        `training` (the JAX version draws them from its key).
    Call under `torch.no_grad()`: nothing here is differentiated.
    """
    cam_loc = torch.broadcast_to(cam_loc, ray_dirs.shape)
    near, far, mask_intersect = intersection_with_unit_sphere(
        cam_loc, ray_dirs, radius=cfg.object_bounding_sphere)
    # signed depths: a camera inside the sphere keeps the full chord
    t_near = torch.sum((near - cam_loc) * ray_dirs, dim=-1)
    t_far = torch.sum((far - cam_loc) * ray_dirs, dim=-1)

    acc_s, acc_e, unfinished, trace_overflow = _bidirectional_sphere_trace(
        sdf_fn, cam_loc, ray_dirs, mask_intersect, t_near, t_far, cfg)

    zero = torch.zeros_like(acc_s)
    dists = torch.where(mask_intersect, acc_s, zero)
    network_object_mask = (acc_s < acc_e) & mask_intersect
    sampler_mask = unfinished
    _, s_t, s_obj, sampler_overflow = _dense_ray_sampler(
        sdf_fn, cam_loc, ray_dirs, object_mask, acc_s, acc_e, sampler_mask,
        cfg, training)
    dists = torch.where(sampler_mask, s_t, dists)
    network_object_mask = torch.where(sampler_mask, s_obj, network_object_mask)
    points = fma(dists[..., None], ray_dirs, cam_loc)

    if training:
        if u is None:
            raise ValueError("ray_trace(training=True) needs the min-SDF "
                             "step fractions `u`")
        in_mask = ~network_object_mask & object_mask & ~sampler_mask
        out_mask = ~object_mask & ~sampler_mask
        need = in_mask | out_mask
        # outside the bounding sphere: closest point to the origin
        left_out = need & ~mask_intersect
        t_perp = -torch.sum(ray_dirs * cam_loc, dim=-1)
        dists = torch.where(left_out, t_perp, dists)
        # inside: random-stratified min-SDF point on the valid interval
        fix = need & mask_intersect
        t_lo = torch.where(network_object_mask & out_mask, acc_s, t_near)
        _, m_t = _minimal_sdf_points(sdf_fn, u, cam_loc, ray_dirs, t_lo,
                                     t_far, cfg.sampler_chunk_rays,
                                     in_kernel=cfg.sampler_in_kernel)
        dists = torch.where(fix, m_t, dists)
        points = fma(dists[..., None], ray_dirs, cam_loc)

    return RayTraceResult(points=points, dists=dists,
                          network_object_mask=network_object_mask,
                          mask_intersect=mask_intersect,
                          sampler_mask=sampler_mask,
                          trace_overflow=trace_overflow,
                          sampler_overflow=sampler_overflow)
