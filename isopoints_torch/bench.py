"""Trace, projection and splat benchmark of the port (the three sections
of the JAX package's bench.py, with its constants).

    python -m isopoints_torch.bench [--device cpu] [--n-rays N]
        [--n-points P] [--fit-points F] [--profile]

A 4×256 IGR field (`SDFField`, no positional encoding; bench.py:76) is
fitted to an r = 0.6 sphere (300 Adam steps at lr 1e-3 on 8192 uniform
points in [−1.2, 1.2]³ per step, MSE to |x| − 0.6, from a seeded
generator; bench.py:40-66). Then 262,144 rays from a camera at (0, 0, −2)
with angles U(±0.35) are traced under the production schedule of
bench.py:135-149 (`BENCH_SCHEDULE`): a bf16 coarse phase with
stall-on-cross, the 4-stage compaction chain with the fused backstep,
end-front gating and the in-kernel sampler with a coarse sweep and a 2e-3
margin. It prints the per-trace time, rays/s, the MLP roofline line of
bench.py:186-216 (`trace_roofline`, H100 peaks) and the two overflow
counters (asserted 0, as bench.py:218-225 does), then the Newton projection rate
and converged fraction of 65,536 points at 5e-5 in f32, bf16 and the
bf16→f32 hybrid (`max_iters=4, coarse_iters=8, coarse_tolerance=1e-3`;
bench.py:241-279), and one JSON line with these numbers. `--profile`
runs one more trace and one more splat frame under torch.profiler and
prints the device's busy share of each and its kernels by device time. The fused
callables launch the CUDA kernels on the card; with `--device cpu` they
run their plain versions (use small `--n-rays`, `--n-points` and
`--fit-points` there).

The splat section (bench.py:281-377): 24,576 splats on the r = 0.7 sphere
(normals = directions, from a seeded generator), a camera at distance 2.5
with focal length 2, 512 px, `use_pallas` and a strip capacity of 1280;
the kNN splat spacing hoisted out of the frame. A frame is forward and
backward of Σ occupancy + Σ_{zbuf>0} zbuf with respect to the points
(compute_splat_params → rasterize_splats → autograd). It prints the frame
time (median of 3 runs of `SPLAT_REP` frames, host clock with the card
synchronised), splats/s, the spacing's time per point-set refresh and the
candidates the capacities dropped (asserted 0, as bench.py:368-375 does).
With `--device cpu` it takes bench.py's own off-TPU size, 2048 splats at
64 px.
"""

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from isopoints_torch import tracing
from isopoints_torch.core.camera import (PerspectiveCamera,
                                         look_at_view_transform)
from isopoints_torch.models.fields import SDFField
from isopoints_torch.models.levelset import project_points_newton
from isopoints_torch.models.raytracing import (RayTraceResult,
                                               RayTracingConfig, ray_trace)
from isopoints_torch.ops.fused_mlp import PlainSDF, make_fused_igr_sdf
from isopoints_torch.rendering.rasterizer import (RasterizationSettings,
                                                  compute_splat_params,
                                                  rasterize_splats,
                                                  splat_spacing)
from isopoints_torch.utils.profiling import mlp_eval_roofline

N_RAYS = 262_144
N_POINTS = 65_536
FIT_STEPS = 300
FIT_POINTS = 8192
RADIUS = 0.6
# bench.py:135-149
BENCH_SCHEDULE = dict(sphere_tracing_iters=21, sampler_chunk_rays=8192,
                      sampler_fraction=0.09375,
                      trace_compact_after=(6, 9, 13, 17),
                      trace_compact_fraction=(0.65, 0.42, 0.21, 0.14),
                      coarse_trace_iters=6, sampler_coarse=True,
                      sampler_coarse_margin=2e-3, coarse_stall_on_cross=True,
                      fused_backstep=True, trace_gate_end_front=True,
                      sampler_in_kernel=True)


# bench.py:293-311
N_SPLATS = 24_576
SPLAT_IMAGE_SIZE = 512
SPLAT_CPU = (2048, 64)          # bench.py's size off the TPU
SPLAT_STRIP = 1280
SPLAT_REP = 3


def bench_config(**overrides) -> RayTracingConfig:
    return RayTracingConfig(**{**BENCH_SCHEDULE, **overrides})


UPPER_BOUND = " (upper bound: early-exit rays counted full)"


def trace_roofline(cfg: RayTracingConfig, n_rays: int, ms: float):
    """bench.py:186-216's roofline of one trace of `n_rays` rays in `ms`:
    an UPPER BOUND on the MLP evaluations of the schedule (rays that stop
    early are counted to the end; compaction stages shrink the marched
    width, the presweep the dense-swept one), each one of the 4x256 field. Its `report()`, with UPPER_BOUND,
    is bench.py's line, against the H100's float32 product peak
    (utils/profiling.py)."""
    lsi = 1 + cfg.line_step_iters
    lsi_fine = 1 if cfg.fused_backstep else lsi   # fused: 1 evaluation an iteration
    stages = cfg.trace_compact_after
    stages = (stages,) if isinstance(stages, int) and stages > 0 else \
        (tuple(stages) if isinstance(stages, (tuple, list)) else ())
    fr = cfg.trace_compact_fraction
    fr = (fr,) * len(stages) if isinstance(fr, float) else fr
    full_end = stages[0] if stages else cfg.sphere_tracing_iters
    lsi_coarse = 1 if cfg.coarse_stall_on_cross else lsi
    evals_per_ray = 2.0 * (full_end + 1) * lsi_coarse   # full-width coarse phase
    bounds = list(stages[1:]) + [cfg.sphere_tracing_iters]
    for a, nxt, f in zip(stages, bounds, fr):
        evals_per_ray += 2.0 * (nxt - a) * lsi_fine * f   # compacted stages
    sf = cfg.sampler_fraction
    if cfg.sampler_presweep >= 2:   # the presweep shrinks the dense-swept width
        evals_per_ray += sf * (cfg.sampler_presweep
                               + cfg.sampler_dense_fraction * cfg.n_steps
                               + cfg.n_secant_steps)
    else:
        evals_per_ray += sf * (cfg.n_steps + cfg.n_secant_steps)
    return mlp_eval_roofline("sphere_trace_mlp", int(n_rays * evals_per_ray),
                             [3, 256, 256, 256, 256, 1], ms / 1e3)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_sphere_field(device, n_steps: int = FIT_STEPS,
                     n_points: int = FIT_POINTS, seed: int = 0
                     ) -> Tuple[SDFField, float]:
    """The bench field fitted to the r = 0.6 sphere's distance; returns
    (field, last MSE)."""
    g = torch.Generator(device=device).manual_seed(seed)
    field = SDFField(hidden_size=256, n_layers=4, num_frequencies=0,
                     generator=g, device=device)
    opt = torch.optim.Adam(field.parameters(), lr=1e-3)
    loss = torch.zeros((), device=device)
    for _ in range(n_steps):
        pts = torch.rand((n_points, 3), generator=g, device=device) * 2.4 - 1.2
        gt = torch.linalg.norm(pts, dim=-1) - RADIUS
        loss = torch.mean((field.sdf(pts) - gt) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return field, float(loss.detach())


def make_rays(n: int, device, seed: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cam (1, n, 3), dirs (1, n, 3), object mask (1, n)): the camera at
    (0, 0, −2), directions (tan a, tan b, 1) normalised, a, b ~ U(±0.35)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ang = torch.rand((1, n, 2), generator=g, device=device) * 0.7 - 0.35
    dirs = torch.stack([torch.tan(ang[..., 0]), torch.tan(ang[..., 1]),
                        torch.ones((1, n), device=device)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    cam = torch.tensor([0.0, 0.0, -2.0], device=device).expand(1, n, 3)
    return cam.contiguous(), dirs, torch.ones((1, n), dtype=torch.bool,
                                              device=device)


def trace_fns(field: SDFField, plain: bool = False
              ) -> Tuple[Callable, Callable]:
    """(fine, coarse) callables: the fused f32 and bf16 kernels, or with
    `plain` their plain versions (no sampler, no march)."""
    fine = make_fused_igr_sdf(field)
    if plain:
        return PlainSDF(fine.pack), PlainSDF(fine.pack, "bf16")
    return fine, make_fused_igr_sdf(field, "bf16")


@torch.no_grad()
def trace(fine: Callable, coarse: Callable, rays, cfg: RayTracingConfig
          ) -> RayTraceResult:
    cam, dirs, gt = rays
    return ray_trace(fine, cam, dirs, gt, None, cfg, training=False,
                     sdf_fn_coarse=coarse)


def time_trace(fine, coarse, rays, cfg, reps: int) -> Tuple[float, RayTraceResult]:
    """Median wall time of `reps` traces after one warm-up, in ms (host
    clock around each trace, the card synchronised)."""
    dev = rays[1].device
    res = trace(fine, coarse, rays, cfg)
    times = []
    for _ in range(reps):
        sync(dev)
        t = time.perf_counter()
        res = trace(fine, coarse, rays, cfg)
        sync(dev)
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times), res


def projection_points(n: int, device, seed: int = 9
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand((1, n, 3), generator=g, device=device) * 1.6 - 0.8
    return pts, torch.ones((1, n), dtype=torch.bool, device=device)


def time_projection(fn, pts, mask, tolerance: float = 5e-5,
                    max_iters: int = 10, fn_coarse: Optional[Callable] = None,
                    coarse_iters: int = 0, reps: int = 3
                    ) -> Tuple[float, float, float]:
    """(projections/s, converged fraction, median ms) of Newton projection
    at `tolerance` (bench.py:241-270)."""
    run = lambda: project_points_newton(
        fn, pts, mask, max_iters=max_iters, tolerance=tolerance,
        sdf_fn_coarse=fn_coarse, coarse_iters=coarse_iters,
        coarse_tolerance=1e-3)
    res = run()
    times = []
    for _ in range(reps):
        sync(pts.device)
        t = time.perf_counter()
        res = run()
        sync(pts.device)
        times.append(time.perf_counter() - t)
    dt = statistics.median(times)
    frac = float(res.mask.sum()) / pts.shape[1]
    return pts.shape[1] / dt, frac, 1e3 * dt


def profile_call(fn, device, label: str, log=print, top: int = 12) -> Dict:
    """One call of `fn` under torch.profiler, after a warm-up call: the
    device's busy share of its wall time (the union of its device events,
    overlaps counted once) and the kernels by device time (the `top` ones
    logged, all returned)."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        raise ValueError("profiling measures the card: it needs CUDA tensors")
    fn()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t)
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy = tracing.union([(e.time_range.start, e.time_range.end)
                          for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA])
    busy_ms = sum(b - a for a, b in busy) / 1e3
    log(f"profile: {label} wall {wall_ms:.3f} ms (under the profiler), device "
        f"busy {busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}%")
    for e in rows[:top]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / 1e3 / busy_ms:5.1f}% "
            f"x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "kernels": [(e.key, dev_us(e) / 1e3, e.count) for e in rows]}


class SplatScene(NamedTuple):
    points: torch.Tensor    # (1, N, 3) on the r = 0.7 sphere
    normals: torch.Tensor   # (1, N, 3) the directions
    mask: torch.Tensor      # (1, N)
    camera: PerspectiveCamera
    settings: RasterizationSettings
    spacing: torch.Tensor   # (1, N) the hoisted kNN spacing


def splat_scene(n: int, image_size: int, device, seed: int = 11,
                **settings) -> SplatScene:
    """bench.py's splat workload: n splats on the r = 0.7 sphere, the
    camera at (0, 0, 2.5)'s look-at, focal 2, `use_pallas`, strip capacity
    1280 (`settings` override RasterizationSettings fields)."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn((1, n, 3), generator=g, device=device)
    normals = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    mask = torch.ones((1, n), dtype=torch.bool, device=device)
    R, T = look_at_view_transform([2.5], [0.0], [0.0], device=device)
    cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0, device=device)
    st = RasterizationSettings(**{**dict(image_size=image_size, use_pallas=True,
                                         max_points_per_strip=SPLAT_STRIP),
                                  **settings})
    pts = 0.7 * normals
    return SplatScene(pts, normals, mask, cam, st, splat_spacing(pts, mask, st))


def splat_step(scene: SplatScene, settings: Optional[RasterizationSettings] = None):
    """One frame: (loss, d loss / d points, d loss / d pts_ndc, fragments)
    of Σ occupancy + Σ_{zbuf>0} zbuf (bench.py:325-331)."""
    st = settings or scene.settings
    pts = scene.points.detach().requires_grad_(True)
    sp = compute_splat_params(pts, scene.normals, scene.mask, scene.camera, st,
                              spacing=scene.spacing)
    frags = rasterize_splats(sp.pts_ndc, sp.ellipse, sp.radii, sp.cutoff,
                             sp.mask, st)
    loss = (torch.sum(frags.occupancy)
            + torch.sum(torch.where(frags.zbuf > 0, frags.zbuf, 0.0)))
    grad, grad_ndc = torch.autograd.grad(loss, (pts, sp.pts_ndc))
    return loss.detach(), grad, grad_ndc, frags


def time_frames(fn, device, reps: int = 3) -> float:
    """Median over `reps` runs of the time of `SPLAT_REP` calls of `fn`,
    per call, in ms (host clock, the card synchronised), after one warm-up
    call."""
    fn()
    times = []
    for _ in range(reps):
        sync(device)
        t = time.perf_counter()
        for _ in range(SPLAT_REP):
            fn()
        sync(device)
        times.append(1e3 * (time.perf_counter() - t) / SPLAT_REP)
    return statistics.median(times)


def run_splat(device="cuda", n: int = N_SPLATS, image_size: int = SPLAT_IMAGE_SIZE,
              reps: int = 3, log=print, profile: bool = False) -> Dict:
    """The splat section; returns its numbers. With `profile` (on the card)
    one more frame runs under torch.profiler."""
    dev = torch.device(device)
    scene = splat_scene(n, image_size, dev)
    frame_ms = time_frames(lambda: splat_step(scene), dev, reps)
    spacing_ms = time_frames(lambda: splat_spacing(scene.points, scene.mask,
                                                   scene.settings), dev, reps)
    _, grad, _, frags = splat_step(scene)
    ovf = int(frags.tile_overflow.sum())
    st = scene.settings
    log(f"splat_fwd_bwd_points_per_s: {n / frame_ms * 1e3:.0f} ({n} splats @ "
        f"{image_size}px, {frame_ms:.3f} ms/frame; +{spacing_ms:.3f} ms kNN "
        f"spacing per point-set refresh, hoisted)")
    log(f"splat_tile_overflow: {ovf} dropped candidates (strip cap "
        f"{st.max_points_per_strip}, tile cap {st.max_points_per_tile})")
    prof = (profile_call(lambda: splat_step(scene), dev, "splat frame", log)
            if profile else None)
    return {"splat_fwd_bwd_points_per_s": n / frame_ms * 1e3,
            "frame_ms": frame_ms, "spacing_ms": spacing_ms, "n_splats": n,
            "image_size": image_size, "splat_tile_overflow": ovf,
            "grad_finite": bool(torch.isfinite(grad).all()), "profile": prof}


def run(device="cuda", n_rays: int = N_RAYS, n_points: int = N_POINTS,
        fit_steps: int = FIT_STEPS, fit_points: int = FIT_POINTS,
        reps: int = 5, log=print, profile: bool = False) -> Dict:
    """The benchmark; returns its numbers (see the module docstring). With
    `profile` (on the card) one more trace runs under torch.profiler."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    field, mse = fit_sphere_field(dev, fit_steps, fit_points)
    log(f"field fitted to r={RADIUS} sphere, mse {mse:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    fine, coarse = trace_fns(field)
    rays = make_rays(n_rays, dev)
    cfg = bench_config()
    ms, res = time_trace(fine, coarse, rays, cfg, reps)
    ovf_trace, ovf_sampler = int(res.trace_overflow), int(res.sampler_overflow)
    log(f"trace: {ms:.3f} ms per {n_rays} rays (median of {reps}), "
        f"{n_rays / (ms / 1e3):.0f} rays/s; hits "
        f"{int(res.network_object_mask.sum())}, sampler rays "
        f"{int(res.sampler_mask.sum())}")
    log(trace_roofline(cfg, n_rays, ms).report() + UPPER_BOUND)
    log(f"compaction_overflow: trace={ovf_trace} sampler={ovf_sampler} of "
        f"{n_rays} rays")
    prof = (profile_call(lambda: trace(fine, coarse, rays, cfg), dev, "trace", log)
            if profile else None)
    pts, mask = projection_points(n_points, dev)
    proj = {}
    for label, fn, kw in (("f32", fine, {}), ("bf16", coarse, {}),
                          ("hybrid", fine, dict(max_iters=4, fn_coarse=coarse,
                                                coarse_iters=8))):
        rate, frac, p_ms = time_projection(fn, pts, mask, **kw)
        proj[label] = {"per_s": rate, "converged": frac, "ms": p_ms}
        note = "" if frac >= 0.90 else "  [<90% converged]"
        log(f"iso_point_projections_per_s[{label}]: {rate:.0f} (converged "
            f"{100 * frac:.1f}% of {n_points}, tol=5e-05, {p_ms:.3f} ms){note}")
    return {"trace_ms": ms, "rays_per_s": n_rays / (ms / 1e3),
            "n_rays": n_rays, "fit_mse": mse, "overflow_trace": ovf_trace,
            "overflow_sampler": ovf_sampler, "projections": proj,
            "profile": prof, "field": field, "result": res}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-rays", type=int, default=N_RAYS)
    ap.add_argument("--n-points", type=int, default=N_POINTS)
    ap.add_argument("--fit-points", type=int, default=FIT_POINTS)
    ap.add_argument("--profile", action="store_true",
                    help="profile one trace and one splat frame (device busy "
                         "share, kernels)")
    a = ap.parse_args(argv)
    if a.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    out = run(a.device, a.n_rays, a.n_points, fit_points=a.fit_points,
              log=lambda m: print(m, file=sys.stderr), profile=a.profile)
    # the capacities must be lossless, else rays/s is bought by dropping
    # rays (bench.py:218-225)
    if out["overflow_trace"] or out["overflow_sampler"]:
        raise SystemExit(f"bench capacities overflowed: trace "
                         f"{out['overflow_trace']} sampler "
                         f"{out['overflow_sampler']}")
    dev = torch.device(a.device)
    n, size = SPLAT_CPU if dev.type == "cpu" else (N_SPLATS, SPLAT_IMAGE_SIZE)
    splat = run_splat(a.device, n, size, log=lambda m: print(m, file=sys.stderr),
                      profile=a.profile)
    # the capacities must be lossless on this workload (bench.py:368-375)
    if splat["splat_tile_overflow"]:
        raise SystemExit(f"splat capacities overflowed: "
                         f"{splat['splat_tile_overflow']} dropped candidates")
    print(json.dumps({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "metric": "sphere_traced_rays_per_s", "value": out["rays_per_s"],
        "unit": "rays/s", "trace_ms": out["trace_ms"],
        "n_rays": out["n_rays"], "overflow_trace": out["overflow_trace"],
        "overflow_sampler": out["overflow_sampler"],
        "projections": out["projections"],
        "splat_fwd_bwd_points_per_s": splat["splat_fwd_bwd_points_per_s"],
        "splat_frame_ms": splat["frame_ms"], "splat_spacing_ms": splat["spacing_ms"],
        "n_splats": splat["n_splats"], "splat_image_size": splat["image_size"],
        "splat_tile_overflow": splat["splat_tile_overflow"]}))


if __name__ == "__main__":
    main()
