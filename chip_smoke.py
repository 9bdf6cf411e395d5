#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (isopoints_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build every kernel under
     isopoints_torch/csrc/ (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch twin at full width (SIREN 3x256,
     seeded): fused MLP value and value+grad on 262,144 points, the sampler
     on 16,384 rays (100 linspace steps + 8 secant steps, and 100 random
     steps without secant); max error against the stated tolerance, kernel
     and twin times (median of 7 after warm-up, CUDA events) and the bound;
  3. the main path: isopoints_torch/configs/mvr_warmup_siren.yml through
     isopoints_torch.factories, 5 warm-up train_steps on cuda with every
     launch counter set to 0 just before and read just after; then the
     same step's loss computed with the fused kernels and with the plain
     field on identical draws must agree;
  4. one JSON line {"kernels": [...]} (each kernel at the shapes the main
     path gives it), then the device line {"ok": true, "device": {...}}.

Exits non-zero without a result when CUDA is unavailable.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_PEAK = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12    # H100 SXM device memory, bytes/s
N_STEPS_SMOKE = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of `fn` after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mlp_flops(n_points: int, hidden: int, n_hidden: int) -> float:
    """Multiply-adds of one SIREN value eval, 2 FLOP each."""
    return 2.0 * n_points * (3 * hidden + n_hidden * hidden * hidden + hidden)


def bound_ms(flops: float, n_bytes: float):
    t_ops, t_bytes = flops / F32_PEAK, n_bytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, ROOT)
    from isopoints_torch.config import load_config
    from isopoints_torch.core.camera import cameras_from_matrices
    from isopoints_torch.factories import (create_dataset, create_model,
                                           create_trainer)
    from isopoints_torch.models.fields import SirenField
    from isopoints_torch.ops import _build, fused_mlp, fused_sampler
    from isopoints_torch.training.trainer import compute_loss
    from isopoints_torch.utils import linspace01

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    t0 = time.time()
    libs = _build.build_all()
    print(f"kernel build: {time.time() - t0:.1f} s for {sorted(libs)}")

    # ---- 2. kernels against their twins at full width
    hidden, n_hidden = 256, 3
    gen = torch.Generator(device=dev).manual_seed(0)
    field = SirenField(hidden_size=hidden, n_layers=n_hidden, generator=gen,
                       device=dev)
    sdf = fused_mlp.make_fused_siren_sdf(field)
    pack = sdf.pack
    plain = lambda p: fused_mlp.siren_sdf_plain(pack, p)
    w_bytes = 4 * sum(w.numel() + b.numel() for w, b in zip(pack.ws, pack.bs))

    def check_mlp(n, tol_v, tol_g, with_grad):
        x = torch.rand((n, 3), generator=gen, device=dev) * 2 - 1
        if with_grad:
            v, g = sdf.sdf_and_grad(x)
            v_ref, g_ref = fused_mlp.siren_sdf_and_grad_plain(pack, x)
            err_g = float((g - g_ref).abs().max())
            scale_g = float(g_ref.abs().max())
            if err_g > tol_g * max(1.0, scale_g):
                fail(f"fused_mlp grad err {err_g} > {tol_g}·max(1, {scale_g})")
        else:
            v, v_ref, err_g = sdf(x), plain(x), 0.0
        err_v = float((v - v_ref).abs().max())
        if not (err_v <= tol_v and torch.isfinite(v).all()):
            fail(f"fused_mlp value err {err_v} > {tol_v}")
        run = (lambda: sdf.sdf_and_grad(x)) if with_grad else (lambda: sdf(x))
        run_p = ((lambda: fused_mlp.siren_sdf_and_grad_plain(pack, x))
                 if with_grad else (lambda: plain(x)))
        ms, plain_ms = time_ms(run), time_ms(run_p)
        b_ms, b_by = bound_ms(mlp_flops(n, hidden, n_hidden) * (4 if with_grad else 1),
                              n * (12 + (16 if with_grad else 4)) + w_bytes)
        return max(err_v, err_g), ms, plain_ms, b_ms, b_by

    def check_sampler(n_rays, steps, n_secant):
        g = torch.Generator(device=dev).manual_seed(n_rays + n_secant)
        cam = torch.tensor([0.0, 0.0, -2.0], device=dev).expand(n_rays, 3).contiguous()
        d = torch.randn((n_rays, 3), generator=g, device=dev) * 0.3
        d[:, 2] = 1.0
        d = d / d.norm(dim=-1, keepdim=True)
        t_lo = 0.8 + 0.4 * torch.rand(n_rays, generator=g, device=dev)
        t_hi = t_lo + 2.2 * torch.rand(n_rays, generator=g, device=dev)
        args = (cam, d, t_lo, t_hi, steps)
        out = sdf.fused_ray_sampler(*args, n_secant=n_secant)
        ref = fused_sampler.sweep_plain(plain, *args, n_secant)
        same = (out[0] == ref[0]) & (out[2] == ref[2])
        frac = 1.0 - float(same.float().mean())
        hit = same & (ref[1] < 0)
        err_f = float((out[1] - ref[1])[same].abs().max())
        err_z = float((out[3] - ref[3])[hit].abs().max()) if n_secant else 0.0
        if frac > 1e-3 or err_f > 1e-5 or err_z > 1e-4:
            fail(f"fused_sampler: {frac:.2e} of picks differ (tol 1e-3), "
                 f"f_pick err {err_f} (tol 1e-5), z_secant err {err_z} (tol 1e-4)")
        ms = time_ms(lambda: sdf.fused_ray_sampler(*args, n_secant=n_secant))
        plain_ms = time_ms(lambda: fused_sampler.sweep_plain(plain, *args, n_secant))
        n_evals = n_rays * (steps.shape[0] + n_secant)
        b_ms, b_by = bound_ms(mlp_flops(n_evals, hidden, n_hidden),
                              n_rays * 48 + steps.numel() * 4 + w_bytes)
        return max(err_f, err_z), frac, ms, plain_ms, b_ms, b_by

    print("tolerances: MLP value |err| <= 2e-5, grad |err| <= 1e-4·max(1,|g|); "
          "sampler picks equal on >= 99.9% of rays, f_pick |err| <= 1e-5, "
          "z_secant |err| <= 1e-4 on crossing rays")
    for n, grad in ((262_144, False), (262_144, True)):
        err, ms, pms, bms, by = check_mlp(n, 2e-5, 1e-4, grad)
        print(f"fused_mlp {'value+grad' if grad else 'value'} n={n}: max_abs_err "
              f"{err:.3g}  kernel {ms:.3f} ms  twin {pms:.3f} ms  bound {bms:.3f} ms ({by})")
    for steps, ns, what in ((linspace01(100, dev), 8, "linspace+secant8"),
                            (torch.rand(100, generator=gen, device=dev), 0,
                             "random, no secant")):
        err, frac, ms, pms, bms, by = check_sampler(16_384, steps, ns)
        print(f"fused_sampler {what} rays=16384: max_abs_err {err:.3g}  picks "
              f"differing {frac:.2e}  kernel {ms:.3f} ms  twin {pms:.3f} ms  "
              f"bound {bms:.3f} ms ({by})")

    # ---- 3. the main path: warm-up training steps through the factories
    cfg = load_config(os.path.join(ROOT, "isopoints_torch", "configs",
                                   "mvr_warmup_siren.yml"))
    data = create_dataset(cfg, device=dev)
    images = torch.as_tensor(data["img.rgb"], device=dev)
    masks = torch.as_tensor(data["img.mask"], device=dev)
    mask_frac = float(masks.mean())
    if not 0.02 < mask_frac < 0.9:
        fail(f"synthetic sphere masks cover {mask_frac:.3f} of the pixels")
    model = create_model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    trainer = create_trainer(model, cfg, seed=0, device=dev)
    state = trainer.init_state()
    views = [(2 * it % 24, (2 * it + 7) % 24) for it in range(N_STEPS_SMOKE)]

    def batch(idx):
        i = torch.as_tensor(idx, device=dev)
        cam = cameras_from_matrices(data["camera_mat"][list(idx)],
                                    data["focal_length"],
                                    data["principal_point"], dev)
        return images[i], masks[i], cam

    kernels = (fused_mlp.KERNEL, fused_sampler.KERNEL)
    for k in kernels:
        k.launches = 0
    step_ms, losses = [], []
    for idx in views:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = trainer.train_step(state, *batch(idx))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        losses.append(metrics)
    launches = {k.name: k.launches for k in kernels}
    for i, m in enumerate(losses):
        print(f"step {i}: " + " ".join(f"{k}={v:.6g}" for k, v in m.items())
              + f" ({step_ms[i]:.1f} ms)")
    print(f"median warm-up step: {statistics.median(step_ms):.2f} ms "
          f"(2 views x {cfg.training.n_rays} rays); launches in "
          f"{N_STEPS_SMOKE} steps: {launches}")
    loss_keys = ("loss", "loss_rgb", "loss_freespace", "loss_occupied",
                 "loss_eikonal")
    for m in losses:
        if not all(torch.isfinite(torch.tensor(m[k])) for k in loss_keys):
            fail(f"non-finite loss terms {m}")
    if not trainer.check_state():
        fail("non-finite parameters after the warm-up steps")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # the same loss with the kernels and with the plain field, same draws
    img, mask, cam = batch(views[0])
    draws = trainer.draw(cfg.training.n_rays, tuple(img.shape[1:3]), 2)
    hp = {k: float(v) for k, v in trainer.scheduler.at(0).items()
          if k in ("lambda_rgb", "lambda_freespace", "lambda_occupied",
                   "sdf_alpha")}
    hp["lambda_eikonal"] = trainer.cfg.lambda_eikonal
    plain_model = create_model(cfg, device=dev)
    plain_model.load_state_dict(model.state_dict())
    plain_model.cfg = dataclasses.replace(model.cfg, use_fused_mlp=False)
    res = {}
    for name, m in (("kernels", model), ("plain", plain_model)):
        with torch.no_grad():
            _, met, _, _ = compute_loss(m, None, None, draws.pixels, img, mask,
                                        cam, draws.eikonal, draws.u_minsdf, hp,
                                        project=False)
        res[name] = {k: float(v) for k, v in met.items()}
    print(f"reference check, kernels vs plain field on one step's draws: {res}")
    n_rays_total = 2 * cfg.training.n_rays
    if abs(res["kernels"]["n_iso"] - res["plain"]["n_iso"]) > 0.005 * n_rays_total:
        fail("iso-point counts of the kernel and plain paths differ by > 0.5%")
    for k in loss_keys:
        a, b = res["kernels"][k], res["plain"][k]
        if abs(a - b) > 1e-2 * abs(b) + 1e-6:
            fail(f"{k}: kernel path {a} vs plain path {b} (rtol 1e-2)")

    # ---- 4. the kernels at the shapes the main path gives them
    # (the seeded full-width field of phase 2, at the main path's shapes:
    # the sphere trace evaluates both fronts of every ray in one call)
    n_trace = 2 * n_rays_total
    mlp_err, mlp_ms, mlp_pms, mlp_b, mlp_by = check_mlp(n_trace, 2e-5, 1e-4, False)
    s_err, _, s_ms, s_pms, s_b, s_by = check_sampler(
        n_rays_total, linspace01(trainer.model.raytrace_cfg.n_steps, dev),
        trainer.model.raytrace_cfg.n_secant_steps)
    rows = [
        {"name": "fused_mlp", "route": "cuda",
         "source": "isopoints_torch/csrc/fused_mlp.cu",
         "replaces": "isopoints_tpu/ops/pallas_mlp.py:250",
         "launches": launches["fused_mlp"], "max_abs_err": mlp_err,
         "ms": mlp_ms, "plain_ms": mlp_pms, "bound_ms": mlp_b,
         "bound_by": mlp_by, "library_ms": None},
        {"name": "fused_sampler", "route": "cuda",
         "source": "isopoints_torch/csrc/fused_sampler.cu",
         "replaces": "isopoints_tpu/ops/pallas_sampler.py:52",
         "launches": launches["fused_sampler"], "max_abs_err": s_err,
         "ms": s_ms, "plain_ms": s_pms, "bound_ms": s_b, "bound_by": s_by,
         "library_ms": None},
    ]
    print(f"main-path shapes: fused_mlp {n_trace} points; fused_sampler "
          f"{n_rays_total} rays x {trainer.model.raytrace_cfg.n_steps} steps")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
