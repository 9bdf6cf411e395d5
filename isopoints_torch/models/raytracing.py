"""IDR ray tracing (port of isopoints_tpu/models/raytracing.py).

Full-width over a static (B, N) ray grid with masks, as in the JAX
package: bounding-sphere interval -> bidirectional sphere tracing with
the line-search backstep -> dense sampler + secant for unconverged rays
-> (training) random-stratified min-SDF points for mask-loss pixels.

The production trace schedule (raytracing.py:337-797, 800-888, 1011-1037)
is ported: a coarse (bf16) phase with optional stall-on-cross and a fine
boundary re-validation; a chain of compaction stages into static
ceil(fraction·N) buffers (grown to the busiest row under `grow`), each at
its own precision, coarse stages re-validated fine, unwound in reverse;
the fused backstep; end-front gating; the dense sampler on a compacted
buffer (`sampler_fraction < 1`) with its overflow; the coarse sampler
sweep with its hysteresis margin and fine bracket. With a fused SDF
callable (ops/fused_mlp.py) every evaluation is the fused MLP kernel,
`sampler_in_kernel` runs the sampler in its kernel (ops/fused_sampler.py)
and `trace_in_kernel` the fine fused-backstep stages in the march kernel
(ops/fused_trace.py). With
`sampler_presweep` the sampler certifies rays crossing-free on a coarse
grid first and sweeps only the flagged ones densely (`_presweep_sampler`).
The plain sweep and the secant (`_secant_scan` in the JAX module) live in
ops/fused_sampler.py beside the kernel they are the plain version of.

Each `while_loop` of the JAX module is a Python loop whose exit test
(`any(un_s | un_e)`) is one host synchronisation per iteration; the march
kernel's fixed count needs none.

The DVR pieces are ported too: `sphere_trace_along_rays` (one-directional
tracing from given points, with the value and gradient at the first
iterate) and `find_zero_crossing_between_point_pairs` (a dense sweep of
each segment, the first sign change and the secant, in the SDF and the
occupancy conventions), which `ImplicitModel.pixels_to_world` and the
occupancy model use.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from isopoints_torch import tracing
from isopoints_torch.models.fields import sdf_and_grad
from isopoints_torch.ops.fused_sampler import eval_chunked, secant_scan, sweep_plain
from isopoints_torch.utils import eps_denom, fma, linspace01

SDFFn = Callable[[torch.Tensor], torch.Tensor]  # (..., 3) -> (...)
State = Tuple[torch.Tensor, ...]  # acc_s, acc_e, sdf_s, sdf_e, un_s, un_e, bk_s, bk_e, cur_s, cur_e


def intersection_with_unit_cube(ray0: torch.Tensor, ray_dir: torch.Tensor,
                                side_length: float = 1.0,
                                padding: float = 0.1, eps: float = 1e-6
                                ) -> Tuple[torch.Tensor, ...]:
    """Entry/exit points of rays with the padded cube (raytracing.py:42-79).
    ray0 broadcasts against ray_dir (..., 3). Returns (entry, exit, hit);
    misses get zeros and hit False."""
    ray0 = torch.broadcast_to(ray0, ray_dir.shape)
    half = side_length / 2.0 + padding / 2.0
    # six axis-aligned planes at ±half: t = (±half − o_i) / d_i
    o2 = torch.cat([ray0, ray0], dim=-1)
    d2 = torch.cat([ray_dir, ray_dir], dim=-1)
    plane = torch.cat([torch.full_like(ray0, half),
                       torch.full_like(ray0, -half)], dim=-1)
    t = (plane - o2) / eps_denom(d2, 1e-12)                        # (..., 6)
    p = fma(t[..., None], ray_dir[..., None, :], ray0[..., None, :])
    on_cube = torch.all((p <= half + eps) & (p >= -(half + eps)), dim=-1)
    hit = torch.sum(on_cube.long(), dim=-1) == 2
    big = 1e10
    t_valid = torch.where(on_cube, t, big)
    t0 = torch.amin(t_valid, dim=-1)
    t1 = torch.amin(torch.where(t_valid <= t0[..., None], big, t_valid), dim=-1)
    t0 = torch.where(hit, t0, 0.0)
    t1 = torch.where(hit, t1, 0.0)
    zero = torch.zeros_like(ray0)
    entry = torch.where(hit[..., None], fma(t0[..., None], ray_dir, ray0), zero)
    exit_ = torch.where(hit[..., None], fma(t1[..., None], ray_dir, ray0), zero)
    return entry, exit_, hit


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


class SphereTraceResult(NamedTuple):
    points: torch.Tensor   # (..., 3) final positions
    sdf: torch.Tensor      # (...,) SDF at the final positions
    grad: torch.Tensor     # (..., 3) SDF gradient at the FIRST iterate
    mask: torch.Tensor     # (...,) converged (|sdf| <= tolerance)


@torch.no_grad()
def sphere_trace_along_rays(sdf_fn: SDFFn, ray0: torch.Tensor,
                            ray_dir: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            max_iters: int = 10, tolerance: float = 5e-5,
                            alpha: float = 1.0, radius: float = 1.0,
                            padding: float = 0.1, step_clip: float = 0.1
                            ) -> SphereTraceResult:
    """March p <- p + α·f(p)·d, each step clipped to `step_clip`, until
    |f| <= 0.1·tolerance or the next step would leave the sphere of radius
    + padding (raytracing.py:130-177); converged against the full
    `tolerance`. The gradient is the one at the starting points, as the
    reference returns its initial gradient cache. One host synchronisation
    per iteration (the loop's exit test)."""
    if mask is None:
        mask = torch.ones(ray0.shape[:-1], dtype=torch.bool, device=ray0.device)
    ray_dir = ray_dir / torch.clamp(torch.linalg.norm(ray_dir, dim=-1, keepdim=True),
                                    min=1e-15)
    sdf0, grad0 = sdf_and_grad(sdf_fn, ray0)
    bound = radius + padding
    inside = torch.linalg.norm(ray0, dim=-1) < bound
    pts, sdf = ray0, sdf0
    active = mask & inside & (sdf0.abs() > 0.1 * tolerance)
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        move = alpha * sdf[..., None] * ray_dir
        mnorm = torch.linalg.norm(move, dim=-1, keepdim=True)
        cand = fma(move / torch.clamp(mnorm, min=1e-15),
                   torch.clamp(mnorm, max=step_clip), pts)
        in_sphere = torch.linalg.norm(cand, dim=-1) < bound
        pts = torch.where((active & in_sphere)[..., None], cand, pts)
        sdf = torch.where(active, sdf_fn(pts), sdf)
        active = active & in_sphere & (sdf.abs() > 0.1 * tolerance)
    return SphereTraceResult(points=pts, sdf=sdf, grad=grad0,
                             mask=mask & (sdf.abs() <= tolerance))


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


class RayTraceResult(NamedTuple):
    points: torch.Tensor               # (B, N, 3) surface / fallback points
    dists: torch.Tensor                # (B, N) ray lengths
    network_object_mask: torch.Tensor  # (B, N) ray hits the implicit surface
    mask_intersect: torch.Tensor       # (B, N) ray intersects bounding sphere
    sampler_mask: torch.Tensor         # (B, N) handled by the dense sampler
    trace_overflow: torch.Tensor       # scalar int32 compaction overflow
    sampler_overflow: torch.Tensor     # scalar int32 sampler overflow


# ---------------------------------------------------------------------------
# Compaction helpers (raytracing.py:337-406)
# ---------------------------------------------------------------------------

def _compact_mask(mask: torch.Tensor, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) bool -> (sel (B, cap) int64 indices, sel_ok (B, cap) bool):
    the first `cap` True positions per row, in index order; unused slots
    hold index 0. Overflow drops the highest-index actives."""
    b, n = mask.shape
    ranks = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    put = torch.where(mask & (ranks < cap), ranks, cap).long()
    iota = torch.arange(n, device=mask.device).expand(b, n)
    sel = torch.zeros((b, cap + 1), dtype=torch.long, device=mask.device)
    sel = sel.scatter(1, put, iota)[:, :cap]
    n_active = torch.sum(mask.to(torch.int32), dim=1, keepdim=True)
    sel_ok = torch.arange(cap, device=mask.device)[None, :] < n_active
    # slot `cap` collected the dropped writes; the real slots it never saw
    # keep index 0, as the JAX scatter into zeros leaves them
    return sel, sel_ok


def _compact_gather(sel: torch.Tensor, cols: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """One wide same-index row gather: (B, N) / (B, N, k) arrays -> (B, cap)
    / (B, cap, k), dtypes kept (bools and small ints travel as float32,
    which is exact)."""
    parts, meta = [], []
    for a in cols:
        x = a[..., None] if a.dim() == 2 else a
        parts.append(x.to(torch.float32))
        meta.append((a.dim() == 2, a.dtype, x.shape[-1]))
    table = torch.cat(parts, dim=-1)                              # (B, N, C)
    g = torch.gather(table, 1, sel[..., None].expand(-1, -1, table.shape[-1]))
    outs, off = [], 0
    for was2d, dt, k in meta:
        v = g[..., off:off + k]
        off += k
        outs.append((v[..., 0] if was2d else v).to(dt))
    return outs


def _masked_scatter_wide(dsts: Sequence[torch.Tensor], sel: torch.Tensor,
                         srcs: Sequence[torch.Tensor], sel_ok: torch.Tensor
                         ) -> List[torch.Tensor]:
    """One wide masked scatter: dst[b, sel[b, j]] = src[b, j] where
    sel_ok[b, j]; (B, N) dsts, (B, cap) srcs, dtypes kept."""
    b, n = dsts[0].shape
    table = torch.stack([d.to(torch.float32) for d in dsts], dim=-1)
    src = torch.stack([s.to(torch.float32) for s in srcs], dim=-1)
    src = torch.where(sel_ok[..., None], src, 0.0)
    idx = torch.where(sel_ok, sel, n)
    out = torch.cat([table, table.new_zeros((b, 1, table.shape[-1]))], dim=1)
    out = out.scatter(1, idx[..., None].expand(-1, -1, table.shape[-1]), src)
    return [out[:, :n, j].to(d.dtype) for j, d in enumerate(dsts)]


# ---------------------------------------------------------------------------
# Bidirectional sphere tracing (raytracing.py:469-797)
# ---------------------------------------------------------------------------

def _eval_pair_fn(fn: SDFFn, cam: torch.Tensor, dirs: torch.Tensor):
    def eval_pair(ts, te):
        # both fronts in one batched eval (one kernel launch)
        both = fn(torch.cat([fma(ts[..., None], dirs, cam),
                             fma(te[..., None], dirs, cam)], dim=-2))
        n = ts.shape[-1]
        return both[..., :n], both[..., n:]
    return eval_pair


def _body(st: State, eval_pair, thr: float, cfg: RayTracingConfig) -> State:
    """Reference semantics: advance + in-iteration line-search backstep
    (raytracing.py:516-553). The fused-backstep extras pass through."""
    acc_s, acc_e, sdf_s, sdf_e, un_s, un_e = st[:6]
    cur_s = torch.where(un_s & (sdf_s > thr), sdf_s, 0.0)
    cur_e = torch.where(un_e & (sdf_e > thr), sdf_e, 0.0)
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
    if cfg.trace_gate_end_front:
        un_e = un_e & un_s
    return (acc_s, acc_e, new_s, new_e, un_s, un_e) + tuple(st[6:])


def body_fused(st: State, eval_pair, thr: float, line_search_step: float,
               line_step_iters: int, gate_end_front: bool) -> State:
    """One eval per iteration: a crossing takes its backstep as the next
    iteration's move, the i-th consecutive one scaled (1 − ls)/2^(i−1)
    (raytracing.py:555-591; RayTracingConfig.fused_backstep)."""
    acc_s, acc_e, sdf_s, sdf_e, un_s, un_e, bk_s, bk_e, cur_s, cur_e = st
    fwd_s = torch.where(un_s & (bk_s == 0) & (sdf_s > thr), sdf_s, 0.0)
    fwd_e = torch.where(un_e & (bk_e == 0) & (sdf_e > thr), sdf_e, 0.0)
    scl = 1.0 - line_search_step
    scale_s = scl * torch.exp2(-(bk_s - 1).to(torch.float32))
    scale_e = scl * torch.exp2(-(bk_e - 1).to(torch.float32))
    move_s = torch.where(bk_s > 0, -scale_s * cur_s, fwd_s)
    move_e = torch.where(bk_e > 0, -scale_e * cur_e, fwd_e)
    acc_s = acc_s + move_s
    acc_e = acc_e - move_e
    new_s, new_e = eval_pair(acc_s, acc_e)
    may_s = un_s & (new_s < 0) & (bk_s < line_step_iters)
    may_e = un_e & (new_e < 0) & (bk_e < line_step_iters)
    cur_s = torch.where(may_s & (bk_s == 0), fwd_s, cur_s)
    cur_e = torch.where(may_e & (bk_e == 0), fwd_e, cur_e)
    bk_s = torch.where(may_s, bk_s + 1, 0).to(torch.int32)
    bk_e = torch.where(may_e, bk_e + 1, 0).to(torch.int32)
    not_crossed = acc_s < acc_e
    un_s = un_s & ((bk_s > 0) | ((new_s > thr) & not_crossed))
    un_e = un_e & ((bk_e > 0) | ((new_e > thr) & not_crossed))
    if gate_end_front:
        # keep-alive: drain a pending end-front backstep before freezing
        un_e = un_e & (un_s | (bk_e > 0))
    return (acc_s, acc_e, new_s, new_e, un_s, un_e, bk_s, bk_e, cur_s, cur_e)


def _body_stall(st: State, eval_pair, thr: float, cfg: RayTracingConfig
                ) -> State:
    """One eval per coarse iteration: a crossing front reverts to its last
    outside position and stalls until the fine re-validation resurrects it
    (raytracing.py:593-617; RayTracingConfig.coarse_stall_on_cross)."""
    acc_s, acc_e, sdf_s, sdf_e, un_s, un_e = st[:6]
    fwd_s = torch.where(un_s & (sdf_s > thr), sdf_s, 0.0)
    fwd_e = torch.where(un_e & (sdf_e > thr), sdf_e, 0.0)
    acc_s = acc_s + fwd_s
    acc_e = acc_e - fwd_e
    new_s, new_e = eval_pair(acc_s, acc_e)
    crossed_s = un_s & (new_s < 0)
    crossed_e = un_e & (new_e < 0)
    acc_s = torch.where(crossed_s, acc_s - fwd_s, acc_s)
    acc_e = torch.where(crossed_e, acc_e + fwd_e, acc_e)
    new_s = torch.where(crossed_s, sdf_s, new_s)
    new_e = torch.where(crossed_e, sdf_e, new_e)
    not_crossed = acc_s < acc_e
    un_s = un_s & ~crossed_s & (new_s > thr) & not_crossed
    un_e = un_e & ~crossed_e & (new_e > thr) & not_crossed
    if cfg.trace_gate_end_front:
        un_e = un_e & un_s
    return (acc_s, acc_e, new_s, new_e, un_s, un_e) + tuple(st[6:])


def _run_loop(st: State, eval_pair, start_it: int, max_iters: int,
              thr: float, cfg: RayTracingConfig, is_coarse: bool,
              seen: Optional[List[List[int]]] = None) -> State:
    """The while loop of raytracing.py:619-627: iterate the stage's body
    from `start_it` while it < max_iters and any front is unfinished.
    The exit test counts each row's unfinished rays, and its start fronts,
    in its one sync; `seen` receives those two lists, of the last test (the
    body only retires rays, so they bound the rows on return), and is left
    empty where no test ran. Traced, a test is a `host_syncs.loop`, and
    each iteration's pair evaluations count 2 points a ray of the buffer
    and 2 a ray still unfinished (`mlp.points.march`, `mlp.live.march`)."""
    stall = is_coarse and cfg.coarse_stall_on_cross
    fused = cfg.fused_backstep and not is_coarse
    per_ray = 2 * (1 if stall or fused else 1 + cfg.line_step_iters)
    it = start_it
    if seen is not None:
        seen.clear()
    while it < max_iters:
        rows = torch.stack((st[4] | st[5], st[4])).sum(-1).tolist()
        tracing.count("host_syncs.loop")
        if seen is not None:
            seen[:] = rows
        n_live = sum(rows[0])
        if not n_live:
            break
        tracing.count("mlp.points.march", per_ray * st[4].numel())
        tracing.count("mlp.live.march", per_ray * n_live)
        if stall:
            st = _body_stall(st, eval_pair, thr, cfg)
        elif fused:
            st = body_fused(st, eval_pair, thr, cfg.line_search_step,
                            cfg.line_step_iters, cfg.trace_gate_end_front)
        else:
            st = _body(st, eval_pair, thr, cfg)
        it += 1
    return st


def _grown_capacity(static: int, mask: torch.Tensor,
                    bound: Optional[int]) -> int:
    """The capacity of a growing compaction of `mask` (B, N): the busiest
    row's count where it exceeds `static`, so that no ray is left out.
    `bound` is an upper bound of that count read by the last exit test, or
    None, and the count is then read here (a `host_syncs.grow`). Traced,
    `trace.grown` counts the rays beyond `static`."""
    if bound is None:
        bound = int(torch.count_nonzero(mask, dim=1).max())
        tracing.count("host_syncs.grow")
    if tracing.on():
        tracing.count_device("trace.grown", torch.clamp(
            torch.count_nonzero(mask, dim=1) - static, min=0))
    return max(static, bound)


def _count_pair_eval(rays: torch.Tensor) -> None:
    """A pair evaluation over a whole buffer: 2 points a slot, 2 live a ray
    inside the bounding sphere or in a filled slot (`rays`, a mask)."""
    tracing.count("mlp.points.buffer", 2 * rays.numel())
    tracing.count_device("mlp.live.buffer", rays, 2)


def march_plain(sdf_fn: SDFFn, cam: torch.Tensor, dirs: torch.Tensor,
                state10: Sequence[torch.Tensor], n_iters: int, thr: float,
                line_search_step: float, line_step_iters: int,
                gate_end_front: bool) -> State:
    """The plain version of the march kernel (ops/fused_trace.py):
    `body_fused` run a fixed `n_iters` times on `sdf_fn`."""
    st = tuple(state10)
    eval_pair = _eval_pair_fn(sdf_fn, cam, dirs)
    for _ in range(n_iters):
        st = body_fused(st, eval_pair, thr, line_search_step,
                        line_step_iters, gate_end_front)
    return st


def _stages(cfg: RayTracingConfig) -> Tuple[Tuple[int, ...], Tuple[float, ...]]:
    """Compaction stages: int -> one stage, tuple -> chain; stages at or
    after the last iteration are dropped (raytracing.py:631-644)."""
    raw_stages = cfg.trace_compact_after
    raw_fracs = cfg.trace_compact_fraction
    if isinstance(raw_stages, int):
        raw_stages = (raw_stages,) if raw_stages > 0 else ()
    if isinstance(raw_fracs, (int, float)):
        raw_fracs = (float(raw_fracs),) * len(raw_stages)
    keep = [(a, f) for a, f in zip(raw_stages, raw_fracs)
            if 0 < a < cfg.sphere_tracing_iters]
    stages = tuple(a for a, _ in keep)
    if list(stages) != sorted(set(stages)):
        raise ValueError(f"trace_compact_after stages must be strictly "
                         f"increasing, got {stages}")
    return stages, tuple(f for _, f in keep)


def _bidirectional_sphere_trace(sdf_fn: SDFFn, cam_loc, ray_dirs,
                                mask_intersect, t_near, t_far,
                                cfg: RayTracingConfig,
                                sdf_fn_coarse: Optional[SDFFn] = None,
                                grow: bool = False):
    """March the start (+) and end (−) fronts until both stall or cross
    (raytracing.py:469-797): the optional coarse phase and its fine
    boundary re-validation, the full-width phase, then the compaction
    stages and their unwind. With `grow` a stage's buffer grows to its
    busiest row (`_grown_capacity`). Returns (acc_s, acc_e,
    unfinished_start, overflow, bound): `bound` is an upper bound of any
    row's unfinished start fronts read by the last exit test, None where
    none bounds them."""
    thr = cfg.sdf_threshold
    stages, fracs = _stages(cfg)
    full_end = stages[0] if stages else cfg.sphere_tracing_iters
    coarse_end = (min(cfg.coarse_trace_iters, full_end)
                  if sdf_fn_coarse is not None else 0)
    if (sdf_fn_coarse is not None and stages
            and cfg.coarse_trace_iters > stages[0]
            and cfg.coarse_trace_iters not in stages + (cfg.sphere_tracing_iters,)):
        raise ValueError(
            "coarse_trace_iters must align with a compaction-stage boundary "
            "when compaction starts inside the coarse phase")
    eval_pair = _eval_pair_fn(sdf_fn, cam_loc, ray_dirs)
    zi = torch.zeros(t_near.shape, dtype=torch.int32, device=t_near.device)
    zf = torch.zeros_like(t_near)

    if coarse_end > 0:
        # ---- coarse phase, then a fine re-validation of every front
        with tracing.span("trace.coarse"):
            eval_pair_c = _eval_pair_fn(sdf_fn_coarse, cam_loc, ray_dirs)
            _count_pair_eval(mask_intersect)
            c_s0, c_e0 = eval_pair_c(t_near, t_far)
            c_s0 = torch.where(mask_intersect, c_s0, 0.0)
            c_e0 = torch.where(mask_intersect, c_e0, 0.0)
            st = (t_near, t_far, c_s0, c_e0, mask_intersect & (c_s0 > thr),
                  mask_intersect & (c_e0 > thr), zi, zi, zf, zf)
            st = _run_loop(st, eval_pair_c, 0, coarse_end, thr, cfg,
                           is_coarse=sdf_fn_coarse is not sdf_fn)
        with tracing.span("trace.revalidate"):
            acc_s, acc_e = st[0], st[1]
            bk_s, bk_e = st[6], st[7]
            _count_pair_eval(mask_intersect)
            sdf_s, sdf_e = eval_pair(acc_s, acc_e)
            sdf_s = torch.where(mask_intersect, sdf_s, 0.0)
            sdf_e = torch.where(mask_intersect, sdf_e, 0.0)
            not_crossed = acc_s < acc_e
            un_s = mask_intersect & (((sdf_s > thr) & not_crossed) | (bk_s > 0))
            un_e = mask_intersect & (((sdf_e > thr) & not_crossed) | (bk_e > 0))
            if cfg.trace_gate_end_front:
                un_e = un_e & (un_s | (bk_e > 0))
            st = (acc_s, acc_e, sdf_s, sdf_e, un_s, un_e) + tuple(st[6:])

    with tracing.span("trace.full"):
        if coarse_end <= 0:
            _count_pair_eval(mask_intersect)
            sdf_s, sdf_e = eval_pair(t_near, t_far)
            sdf_s = torch.where(mask_intersect, sdf_s, 0.0)
            sdf_e = torch.where(mask_intersect, sdf_e, 0.0)
            un_s = mask_intersect & (sdf_s > thr)
            un_e = mask_intersect & (sdf_e > thr)
            if cfg.trace_gate_end_front:
                un_e = un_e & un_s
            st = (t_near, t_far, sdf_s, sdf_e, un_s, un_e, zi, zi, zf, zf)
        seen: List[List[int]] = []
        st = _run_loop(st, eval_pair, coarse_end, full_end, thr, cfg,
                       is_coarse=False, seen=seen)
    overflow = torch.zeros((), dtype=torch.int32, device=t_near.device)
    if not stages:
        return st[0], st[1], st[4], overflow, max(seen[1]) if seen else None

    # ---- compacted straggler stages; buffers nest, scatters unwind in
    # reverse at the end
    n0 = st[4].shape[1]
    p2_coarse = cfg.trace_compact_coarse and sdf_fn_coarse is not None
    boundaries = list(stages[1:]) + [cfg.sphere_tracing_iters]
    cam_g, dirs_g = cam_loc, ray_dirs
    frames = []          # (sel, sel_ok, pre-stage acc_s, acc_e, un_s)
    stepper = getattr(sdf_fn, "fused_trace_stepper", None)
    for i, (a, nxt, frac) in enumerate(zip(stages, boundaries, fracs)):
        with tracing.span(f"trace.stage{i + 1}"):
            n_cur = st[4].shape[1]
            cap = min(max(int(math.ceil(n0 * frac)), 1), n_cur)
            active = st[4] | st[5]
            if grow:
                cap = _grown_capacity(cap, active, max(seen[0]) if seen else None)
            sel, sel_ok = _compact_mask(active, cap)
            n_active = torch.sum(active.to(torch.int32), dim=1)
            overflow = overflow + torch.sum(torch.clamp(n_active - cap, min=0)
                                            ).to(torch.int32)
            frames.append((sel, sel_ok, st[0], st[1], st[4]))
            gathered = _compact_gather(sel, list(st) + [cam_g, dirs_g])
            cam_g, dirs_g = gathered[10], gathered[11]
            un_s_in = gathered[4] & sel_ok
            un_e_in = gathered[5] & sel_ok
            state_in = (tuple(gathered[:4]) + (un_s_in, un_e_in)
                        + tuple(gathered[6:10]))
            # per-stage precision: a stage ending at or before the coarse phase's
            # end runs coarse, and is re-validated fine below
            stage_coarse = p2_coarse or (
                sdf_fn_coarse is not None and nxt <= cfg.coarse_trace_iters)
            if (cfg.trace_in_kernel and cfg.fused_backstep and not stage_coarse
                    and stepper is not None):
                # a fixed count of fused iterations over the whole buffer,
                # no exit test; live: the rays unfinished on entry, an upper
                # bound (the kernel keeps no count)
                tracing.count("mlp.points.march",
                              2 * (nxt - a) * sel_ok.numel())
                tracing.count_device("mlp.live.march", un_s_in | un_e_in,
                                     2 * (nxt - a))
                st = stepper(cam_g, dirs_g, state_in, nxt - a, thr,
                             cfg.line_search_step, cfg.line_step_iters,
                             cfg.trace_gate_end_front)
            else:
                fn = sdf_fn_coarse if stage_coarse else sdf_fn
                st = _run_loop(state_in, _eval_pair_fn(fn, cam_g, dirs_g), a, nxt,
                               thr, cfg, is_coarse=fn is not sdf_fn, seen=seen)
            if stage_coarse:
                seen.clear()  # the re-validation may revive a front
                # fine re-validation before the next compaction selects on them
                _count_pair_eval(sel_ok)
                f_s, f_e = _eval_pair_fn(sdf_fn, cam_g, dirs_g)(st[0], st[1])
                ncx = st[0] < st[1]
                r_un_s = un_s_in & (((f_s > thr) & ncx) | (st[6] > 0))
                r_un_e = un_e_in & (((f_e > thr) & ncx) | (st[7] > 0))
                if cfg.trace_gate_end_front:
                    r_un_e = r_un_e & (r_un_s | (st[7] > 0))
                st = (st[0], st[1], f_s, f_e, r_un_s, r_un_e) + tuple(st[6:])

    # unwind: each stage's result back into its parent buffer; overflow
    # beyond capacity keeps its pre-stage state (unfinished -> sampler)
    with tracing.span("trace.unwind"):
        c_acc_s, c_acc_e, c_un_s = st[0], st[1], st[4]
        for sel, sel_ok, p_acc_s, p_acc_e, p_un_s in reversed(frames):
            c_acc_s, c_acc_e, c_un_s = _masked_scatter_wide(
                (p_acc_s, p_acc_e, p_un_s), sel, (c_acc_s, c_acc_e, c_un_s),
                sel_ok)
    # grown, no stage left a ray out: a start front unfinished on return
    # sat in the last buffer, in its row
    return (c_acc_s, c_acc_e, c_un_s, overflow,
            max(seen[1]) if grow and seen else None)


# ---------------------------------------------------------------------------
# Dense sampler and min-SDF points (raytracing.py:800-971)
# ---------------------------------------------------------------------------

def _dense_ray_sampler(sdf_fn: SDFFn, cam_loc, ray_dirs, object_mask, t_lo,
                       t_hi, sampler_mask, cfg: RayTracingConfig,
                       training: bool, sdf_fn_coarse: Optional[SDFFn] = None,
                       filled: Optional[torch.Tensor] = None):
    """Uniform n_steps sweep + first-sign-change pick + secant
    (raytracing.py:800-888). With `sampler_coarse` the sweep runs on the
    coarse fn with the hysteresis margin and the bracket is re-validated
    fine. In the fused kernel when `sampler_in_kernel` and `sdf_fn`
    carries `.fused_ray_sampler` (for a coarse sweep only where its
    `packing_stride` is 3, the JAX rule of :829-836), else the plain sweep.
    With `2 <= sampler_presweep < n_steps` the certify-then-sweep sampler
    runs instead (`_presweep_sampler`). On a compacted buffer, `filled`
    (B,) counts the filled slots leading each row (its `sel_ok`), and only
    those are swept; the others' outputs are zeros, which the caller's
    scatter drops. Returns (points, t, object_mask, overflow): the overflow
    counts presweep-flagged rays beyond the dense buffer's capacity (0
    without the presweep)."""
    if 2 <= cfg.sampler_presweep < cfg.n_steps:
        return _presweep_sampler(sdf_fn, cam_loc, ray_dirs, object_mask, t_lo,
                                 t_hi, sampler_mask, cfg, training,
                                 sdf_fn_coarse)
    steps = linspace01(cfg.n_steps, device=ray_dirs.device)
    use_coarse = cfg.sampler_coarse and sdf_fn_coarse is not None
    margin = cfg.sampler_coarse_margin if use_coarse else 0.0
    fused = getattr(sdf_fn, "fused_ray_sampler", None)
    if (fused is not None and use_coarse
            and getattr(fused, "packing_stride", None) != 3):
        fused = None
    # the sweep's slots, the filled ones (on a compacted buffer the mask is
    # its `sel_ok`) and the ones it computed: the kernel's tiles, every
    # slot in the plain sweep
    tracing.count("sampler.slots", sampler_mask.numel())
    tracing.count_device("sampler.live", sampler_mask)
    if cfg.sampler_in_kernel and fused is not None:
        swept = (torch.zeros((), dtype=torch.int32, device=t_lo.device)
                 if tracing.on() else None)
        t_pick, f_pick, t_min, z_secant = fused(
            cam_loc, ray_dirs, t_lo, t_hi, steps,
            n_secant=cfg.n_secant_steps, margin=margin,
            coarse_sweep=use_coarse, filled=filled, swept=swept)
        if swept is not None:
            tracing.count_device("sampler.swept", swept)
    else:
        t_pick, f_pick, t_min, z_secant = sweep_plain(
            sdf_fn, cam_loc, ray_dirs, t_lo, t_hi, steps,
            cfg.n_secant_steps, margin, cfg.sampler_chunk_rays,
            sdf_fn_coarse=sdf_fn_coarse if use_coarse else None,
            filled=filled)
        tracing.count("sampler.swept", sampler_mask.numel())
    net_surface = f_pick < 0
    secant_ok = net_surface & (object_mask if training
                               else torch.ones_like(net_surface))
    p_out = ~(object_mask & net_surface)
    t_out = torch.where(secant_ok, z_secant,
                        torch.where(p_out, t_min, t_pick))
    pts_out = fma(t_out[..., None], ray_dirs, cam_loc)
    overflow = torch.zeros((), dtype=torch.int32, device=t_lo.device)
    return pts_out, t_out, sampler_mask & net_surface, overflow


def _presweep_sampler(sdf_fn: SDFFn, cam_loc, ray_dirs, object_mask, t_lo,
                      t_hi, sampler_mask, cfg: RayTracingConfig,
                      training: bool, sdf_fn_coarse: Optional[SDFFn] = None):
    """Certify-then-sweep sampler (raytracing.py:891-955).

    `sampler_presweep` uniform steps a ray on the dense fn (the coarse fn
    under `sampler_coarse`, else `sdf_fn`: on the card the fused MLP value
    kernel), `sampler_chunk_rays` rays at a time. A ray is flagged when an
    interval [a, b] of that grid may hold a crossing: a sign change, or
    min(|f_a|, |f_b|) <= lipschitz·seg with seg = |t_hi − t_lo|/(s1 − 1).
    Certified rays are non-surface and take the minimum of the presweep
    grid. The flagged rays are compacted into ceil(N·dense_fraction) slots
    (unused slots hold ray 0, which the scatter drops) and swept by the
    dense sampler with the presweep off (on the card the sampler kernel
    under `sampler_in_kernel`); flagged rays beyond the capacity keep the
    certified default and are counted in the overflow."""
    s1 = cfg.sampler_presweep
    use_coarse = cfg.sampler_coarse and sdf_fn_coarse is not None
    fn_dense = sdf_fn_coarse if use_coarse else sdf_fn
    steps1 = linspace01(s1, device=ray_dirs.device)
    ts1 = fma(steps1, (t_hi - t_lo)[..., None], t_lo[..., None])    # (B, N, S1)
    f1 = eval_chunked(fn_dense, fma(ts1[..., None], ray_dirs[..., None, :],
                                    cam_loc[..., None, :]),
                      cfg.sampler_chunk_rays)
    seg = torch.abs(t_hi - t_lo)[..., None] / max(s1 - 1, 1)
    fa, fb = f1[..., :-1], f1[..., 1:]
    possible = ((torch.sign(fa) != torch.sign(fb))
                | (torch.minimum(fa.abs(), fb.abs())
                   <= cfg.sampler_presweep_lipschitz * seg))
    needs_dense = sampler_mask & possible.any(dim=-1)             # (B, N)
    # certified-ray fallback: the minimum of the presweep grid
    t_min1 = torch.gather(ts1, -1, torch.argmin(f1, dim=-1)[..., None])[..., 0]

    n = sampler_mask.shape[1]
    cap = min(max(int(math.ceil(n * cfg.sampler_dense_fraction)), 1), n)
    sel, sel_ok = _compact_mask(needs_dense, cap)
    cam_g, dirs_g, om_g, tlo_g, thi_g = _compact_gather(
        sel, [cam_loc, ray_dirs, object_mask, t_lo, t_hi])
    _, d_t, d_obj, _ = _dense_ray_sampler(
        sdf_fn, cam_g, dirs_g, om_g, tlo_g, thi_g, sel_ok,
        dataclasses.replace(cfg, sampler_presweep=0), training, sdf_fn_coarse,
        filled=torch.sum(sel_ok, 1, dtype=torch.int32))
    t_out, obj_out = _masked_scatter_wide(
        (t_min1, torch.zeros_like(needs_dense)), sel, (d_t, d_obj), sel_ok)
    n_flagged = needs_dense.to(torch.int32).sum(dim=1)
    overflow = torch.clamp(n_flagged - cap, min=0).sum().to(torch.int32)
    return (fma(t_out[..., None], ray_dirs, cam_loc), t_out,
            sampler_mask & obj_out, overflow)


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
              training: bool = True,
              sdf_fn_coarse: Optional[SDFFn] = None,
              grow: bool = False) -> RayTraceResult:
    """Full IDR ray tracing (raytracing.py:974-1067).

    Args:
      cam_loc: (B, 1, 3) or (B, N, 3) camera centers.
      ray_dirs: (B, N, 3) unit directions.
      object_mask: (B, N) GT silhouette at each ray's pixel.
      u: (n_steps,) min-SDF step fractions in [0, 1); required when
        `training` (the JAX version draws them from its key).
      sdf_fn_coarse: the coarse (bf16) fn of the precision schedule, or
        None to trace fine only.
      grow: each compaction's buffer (the trace stages', the sampler's)
        grows to its busiest row's live count where that exceeds the
        static capacity, so no ray overflows (`Generator`'s renders). By
        default the capacities are static and rays beyond them overflow,
        as in the JAX package.
    Call under `torch.no_grad()`: nothing here is differentiated.
    """
    cam_loc = torch.broadcast_to(cam_loc, ray_dirs.shape)
    near, far, mask_intersect = intersection_with_unit_sphere(
        cam_loc, ray_dirs, radius=cfg.object_bounding_sphere)
    # signed depths: a camera inside the sphere keeps the full chord
    t_near = torch.sum((near - cam_loc) * ray_dirs, dim=-1)
    t_far = torch.sum((far - cam_loc) * ray_dirs, dim=-1)

    acc_s, acc_e, unfinished, trace_overflow, bound = _bidirectional_sphere_trace(
        sdf_fn, cam_loc, ray_dirs, mask_intersect, t_near, t_far, cfg,
        sdf_fn_coarse=sdf_fn_coarse, grow=grow)

    zero = torch.zeros_like(acc_s)
    dists = torch.where(mask_intersect, acc_s, zero)
    network_object_mask = (acc_s < acc_e) & mask_intersect
    sampler_mask = unfinished
    with tracing.span("trace.sampler"):
        if cfg.sampler_fraction >= 1.0:
            _, s_t, s_obj, sampler_overflow = _dense_ray_sampler(
                sdf_fn, cam_loc, ray_dirs, object_mask, acc_s, acc_e,
                sampler_mask, cfg, training, sdf_fn_coarse)
            dists = torch.where(sampler_mask, s_t, dists)
            network_object_mask = torch.where(sampler_mask, s_obj,
                                              network_object_mask)
        else:
            # compact the unconverged rays into a static buffer, sample only
            # those, scatter back; rays beyond capacity count as non-surface
            b, n = sampler_mask.shape
            cap = max(int(math.ceil(n * cfg.sampler_fraction)), 1)
            if grow:
                cap = _grown_capacity(cap, sampler_mask, bound)
            sel, sel_ok = _compact_mask(sampler_mask, cap)
            cam_g, dirs_g, om_g, accs_g, acce_g = _compact_gather(
                sel, [cam_loc, ray_dirs, object_mask, acc_s, acc_e])
            _, s_t, s_obj, ps_ovf = _dense_ray_sampler(
                sdf_fn, cam_g, dirs_g, om_g, accs_g, acce_g, sel_ok, cfg,
                training, sdf_fn_coarse,
                filled=torch.sum(sel_ok, 1, dtype=torch.int32))
            dists, network_object_mask = _masked_scatter_wide(
                (dists, network_object_mask), sel, (s_t, s_obj), sel_ok)
            covered = torch.zeros((b, n + 1), dtype=torch.bool,
                                  device=sel.device).scatter(
                1, torch.where(sel_ok, sel, n), True)[:, :n]
            overflow = sampler_mask & ~covered
            network_object_mask = torch.where(overflow, False,
                                              network_object_mask)
            sampler_overflow = torch.sum(overflow.to(torch.int32)) + ps_ovf
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
                          sampler_overflow=sampler_overflow.to(torch.int32))


@torch.no_grad()
def find_zero_crossing_between_point_pairs(
        sdf_fn: SDFFn, p0: torch.Tensor, p1: torch.Tensor, n_steps: int = 100,
        n_secant_steps: int = 8, is_occupancy: bool = False,
        allow_in_to_out: bool = False, chunk_rays: int = 16384
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first zero crossing on each segment [p0, p1], refined by the
    secant (raytracing.py:1074-1131). SDF convention: outside is f > 0 and
    a crossing counts when it goes from outside to inside (any with
    `allow_in_to_out`); `is_occupancy` flips the sign test (logits > 0
    inside). The `n_steps` values of a segment are evaluated `chunk_rays`
    segments at a time (the same values, bounded memory). Returns (points
    (..., 3), mask (...)); a segment without a crossing gets ones under
    mask False, the reference's fill."""
    seg = p1 - p0
    seg_len = torch.linalg.norm(seg, dim=-1)
    ray_dir = seg / torch.clamp(seg_len[..., None], min=1e-10)
    ts = linspace01(n_steps, device=p0.device) * seg_len[..., None]   # (..., S)
    pts = fma(ts[..., None], ray_dir[..., None, :], p0[..., None, :])
    flat = pts.reshape(-1, n_steps, 3)
    val = torch.cat([sdf_fn(c) for c in flat.split(max(chunk_rays, 1))]
                    ).reshape(ts.shape) if flat.shape[0] else ts.clone()
    sign_mx = torch.cat([torch.sign(val[..., :-1] * val[..., 1:]),
                         torch.ones_like(val[..., :1])], dim=-1)
    countdown = torch.arange(n_steps, 0, -1, dtype=val.dtype, device=val.device)
    cost = sign_mx * countdown
    idx = torch.argmin(cost, dim=-1)
    pick = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]
    crossing = pick(cost, idx) < 0
    f_start = pick(val, idx)
    out_to_in = (f_start < 0.0) if is_occupancy else (f_start > 0.0)
    mask = crossing if allow_in_to_out else crossing & out_to_in
    idx_hi = torch.clamp(idx + 1, max=n_steps - 1)
    d_start, d_end = pick(ts, idx), pick(ts, idx_hi)
    f_end = pick(val, idx_hi)
    # the secant assumes outside > 0: negate the occupancy logits
    if is_occupancy:
        z = secant_scan(lambda x: -sdf_fn(x), -f_start, -f_end, d_start, d_end,
                        p0, ray_dir, n_secant_steps)
    else:
        z = secant_scan(sdf_fn, f_start, f_end, d_start, d_end, p0, ray_dir,
                        n_secant_steps)
    pt = fma(z[..., None], ray_dir, p0)
    return torch.where(mask[..., None], pt, torch.ones_like(pt)), mask
