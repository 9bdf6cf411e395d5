"""Port parity: the production trace schedule (models/raytracing.py), the
hybrid Newton projection and a warm-up training step on an IGR decoder,
and the "uni" ablation arm's schedule on a SIREN decoder, against the JAX
package on the CPU.

The field is an IGR `SDFField` (hidden 64, 4 layers, no positional
encoding) from the JAX init, its head scaled by 1.35 in both packages so
that its slope is near 1, as the fitted bench field's is: sphere-tracing
fronts overshoot the surface where it curves (the backstep, stall-on-cross
and crossing branches all run), and the bench schedule's capacities hold
(no overflow at 1024 rays). JAX traces with its fused kernels in interpret
mode, under `jax.jit` as its callers run it: `highest` as the fine fn and
`bf16` as the coarse fn. The port traces with its fused callables, which
on CPU tensors are their plain versions; `trace_in_kernel` runs the
march's plain version (`march_plain`).

Tolerances. The compaction helpers are bit-equal to JAX's. A trace: the
coarse bf16 values of the two packages are equal up to the summation
order of float32 sums of exact products, so a decision taken on a value
within round-off of a threshold can flip, and a flipped backstep or stall
moves that ray's front by up to a step (measured up to 3e-3 on a stopped
crossing). So: hit and sampler masks differ on at most 1% of the rays;
depths of rays with equal masks agree within 1e-4 on 98% of them; the
overflow counts differ by at most 1% of the rays. The converged-ray
invariant: every ray the trace reports as a hit without the sampler has
f_fine <= thr at its point in each package (a front that stopped after a
crossing sits inside, f < 0, as in JAX). On the CPU a point's value
rounds by the batch it is evaluated in, so here it holds within 1e-6;
the chip check holds it exactly, where the kernel's value of a point does
not depend on its batch. Newton: the valid counts within 1% of
the points; where both converged, 90% of the points within 1e-5 and all
within 1e-3 (the bf16 steps' rounding differences move a start point along
the surface, and the fine steps then converge to another point on it).
Training step: loss terms rtol 1e-3 (one ray's outcome flipping moves a
term by ~1/256).

SIREN: a 2×64 SIREN fitted to the r = 0.6 sphere's SDF in PyTorch (200
Adam steps on seeded points, one thread), its weights handed to both
packages; configs/ablation_compound_uni.yml's schedule (a bf16 coarse
phase of 6 iterations with stall-on-cross inside the first compaction
stage at 8, the fused backstep, the coarse sampler with margin 2e-3, the
end-front gate), with and without `trace_in_kernel`, held to the same
tolerances as the IGR traces; the SIREN bf16 values of the two packages
differ by their sums' order and by JAX's polynomial sine (~1e-7), so the
same decisions can flip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.models import raytracing as jrt
from isopoints_tpu.models.combined import CombinedModel as JCombined
from isopoints_tpu.models.fields import SDFField as JSDF
from isopoints_tpu.models.implicit import ImplicitConfig as JImplicitConfig
from isopoints_tpu.models.levelset import project_points_newton as j_newton
from isopoints_tpu.ops.pallas_mlp import make_fused_igr_sdf as jax_fused_igr
from isopoints_tpu.training.trainer import compute_loss as j_compute_loss
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.camera import cameras_from_matrices
from isopoints_torch.data.synthetic import make_synthetic_mvr, sphere_sdf
from isopoints_torch.models import raytracing as trt
from isopoints_torch.models.combined import CombinedModel
from isopoints_torch.models.fields import SDFField
from isopoints_torch.models.implicit import ImplicitConfig
from isopoints_torch.models.levelset import project_points_newton
from isopoints_torch.ops import fused_mlp, fused_sampler, fused_trace
from isopoints_torch.training.trainer import compute_loss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


THR = 5e-5
# bench.py:135-149, the production schedule
BENCH = dict(sphere_tracing_iters=21, sampler_chunk_rays=8192,
             sampler_fraction=0.09375, trace_compact_after=(6, 9, 13, 17),
             trace_compact_fraction=(0.65, 0.42, 0.21, 0.14),
             coarse_trace_iters=6, sampler_coarse=True,
             sampler_coarse_margin=2e-3, coarse_stall_on_cross=True,
             fused_backstep=True, trace_gate_end_front=True,
             sampler_in_kernel=True)


def _scaled_params(jfield, seed=0, head=1.35):
    params = jfield.init(jax.random.key(seed))
    last = dict(params["layers"][-1])
    last["g"] = last["g"] * head
    last["b"] = last["b"] * head
    return {"layers": params["layers"][:-1] + [last]}


@pytest.fixture(scope="module")
def fns():
    jfield = JSDF(hidden_size=64, n_layers=4, num_frequencies=0)
    params = _scaled_params(jfield)
    tfield = SDFField(hidden_size=64, n_layers=4, num_frequencies=0,
                      device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)},
                         keep_weight_norm=True)
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    j_fine = jax_fused_igr(jfield, params, interpret=True, precision="highest")[0]
    j_coarse = jax_fused_igr(jfield, params, interpret=True, precision="bf16")[0]
    return (j_fine, j_coarse, fused_mlp.make_fused_igr_sdf(tfield),
            fused_mlp.make_fused_igr_sdf(tfield, "bf16"), tfield)


def _fan(n, seed=0):
    """The bench's rays: camera at (0, 0, −2), angles U(±0.35)."""
    rng = np.random.RandomState(seed)
    ang = rng.uniform(-0.35, 0.35, (1, n, 2))
    d = np.stack([np.tan(ang[..., 0]), np.tan(ang[..., 1]), np.ones((1, n))], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cam = np.broadcast_to(np.float32([0.0, 0.0, -2.0]), d.shape).copy()
    return cam, d, np.ones((1, n), bool)


def _trace_both(fns, cfg_kw, n_rays, coarse=True):
    j_fine, j_coarse, t_fine, t_coarse, _ = fns
    cam, d, gt = _fan(n_rays)
    r_j = jax.jit(lambda c, dd, g: jrt.ray_trace(
        j_fine, c, dd, g, jax.random.key(1), jrt.RayTracingConfig(**cfg_kw),
        training=False, sdf_fn_coarse=j_coarse if coarse else None))(
            jnp.asarray(cam), jnp.asarray(d), jnp.asarray(gt))
    with torch.no_grad():
        r_t = trt.ray_trace(t_fine, torch.from_numpy(cam), torch.from_numpy(d),
                            torch.from_numpy(gt), None,
                            trt.RayTracingConfig(**cfg_kw), training=False,
                            sdf_fn_coarse=t_coarse if coarse else None)
    return r_j, r_t


def _assert_converged_invariant(points, hit, sampler, f_fine):
    conv = hit & ~sampler
    assert conv.sum() > 0
    assert np.all(f_fine(points[conv]) <= THR + 1e-6)


def _compare(r_j, r_t, fns):
    j_fine, _, t_fine, _, _ = fns
    hit_j, hit_t = np.asarray(r_j.network_object_mask), r_t.network_object_mask.numpy()
    smp_j, smp_t = np.asarray(r_j.sampler_mask), r_t.sampler_mask.numpy()
    n = hit_j.size
    assert 0 < hit_j.sum() < n and smp_j.sum() > 0
    assert abs(int(r_t.trace_overflow) - int(r_j.trace_overflow)) <= 0.01 * n
    assert abs(int(r_t.sampler_overflow) - int(r_j.sampler_overflow)) <= 0.01 * n
    assert (hit_j != hit_t).sum() <= 0.01 * n
    assert (smp_j != smp_t).sum() <= 0.01 * n
    same = (hit_j == hit_t) & (smp_j == smp_t)
    close = np.abs(r_t.dists.numpy() - np.asarray(r_j.dists)) <= 1e-4
    assert close[same].mean() >= 0.98
    _assert_converged_invariant(np.asarray(r_j.points), hit_j, smp_j,
                                lambda p: np.asarray(j_fine(jnp.asarray(p))))
    with torch.no_grad():
        _assert_converged_invariant(r_t.points.numpy(), hit_t, smp_t,
                                    lambda p: t_fine(torch.from_numpy(p)).numpy())


# ---------------------------------------------------------------------------
# compaction helpers: bit-equal to JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 37, 90, 200])
def test_compaction_helpers_bit_equal(cap):
    rng = np.random.RandomState(cap)
    mask = rng.uniform(size=(2, 200)) < 0.4
    sel_j, ok_j = jrt._compact_mask(jnp.asarray(mask), cap)
    sel_t, ok_t = trt._compact_mask(torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    cols = [rng.randn(2, 200).astype(np.float32), mask,
            rng.randint(0, 3, (2, 200)).astype(np.int32),
            rng.randn(2, 200, 3).astype(np.float32)]
    g_j = jrt._compact_gather(sel_j, [jnp.asarray(c) for c in cols])
    g_t = trt._compact_gather(sel_t, [torch.from_numpy(c) for c in cols])
    for a, b in zip(g_t, g_j):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    srcs = [rng.randn(2, cap).astype(np.float32), rng.uniform(size=(2, cap)) < 0.5]
    dsts = [cols[0], mask]
    s_j = jrt._masked_scatter_wide([jnp.asarray(a) for a in dsts], sel_j,
                                   [jnp.asarray(a) for a in srcs], ok_j)
    s_t = trt._masked_scatter_wide([torch.from_numpy(a) for a in dsts], sel_t,
                                   [torch.from_numpy(a) for a in srcs], ok_t)
    for a, b in zip(s_t, s_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# ray_trace: each schedule option alone, then the bench schedule
# ---------------------------------------------------------------------------

BASE = dict(sphere_tracing_iters=16, n_steps=32)


@pytest.mark.parametrize("name,extra,coarse", [
    ("coarse", dict(coarse_trace_iters=6), True),
    ("stall_on_cross", dict(coarse_trace_iters=6, coarse_stall_on_cross=True), True),
    ("compaction_chain", dict(trace_compact_after=(6, 10),
                              trace_compact_fraction=(0.6, 0.3)), False),
    ("compact_coarse", dict(coarse_trace_iters=4, trace_compact_after=6,
                            trace_compact_fraction=0.6,
                            trace_compact_coarse=True), True),
    ("fused_backstep", dict(fused_backstep=True, sphere_tracing_iters=19), False),
    ("gate_end_front", dict(trace_gate_end_front=True, fused_backstep=True), False),
    ("sampler_fraction", dict(sampler_fraction=0.3), False),
    ("sampler_coarse", dict(sampler_coarse=True, sampler_coarse_margin=2e-3,
                            sampler_in_kernel=True), True),
])
def test_schedule_option_matches_jax(fns, name, extra, coarse):
    r_j, r_t = _trace_both(fns, {**BASE, **extra}, 384, coarse)
    _compare(r_j, r_t, fns)


@pytest.mark.parametrize("in_kernel", [False, True])
def test_bench_schedule_matches_jax(fns, in_kernel):
    """bench.py's schedule at 1024 rays; with `trace_in_kernel` the fine
    stages run the march's plain version (`march_plain`)."""
    cfg = dict(BENCH, trace_in_kernel=in_kernel, n_steps=48)
    r_j, r_t = _trace_both(fns, cfg, 1024)
    _compare(r_j, r_t, fns)
    assert int(r_t.trace_overflow) == int(r_t.sampler_overflow) == 0
    assert (fused_mlp.IGR_KERNEL.launches == fused_sampler.KERNEL.launches
            == fused_trace.KERNEL.launches == 0)


@pytest.mark.parametrize("name", ["compaction_chain", "bench"])
def test_static_capacities_spill_as_jax_and_grown_ones_do_not(fns, name):
    """Capacities small enough to spill: by default the port's trace and
    sampler overflow exactly as many rays as JAX's; with `grow` (the
    Generator's renders) none, and the hits and depths are those of the
    trace with every fraction 1."""
    if name == "bench":
        cfg = dict(BENCH, n_steps=48, trace_compact_fraction=(0.3, 0.2, 0.1, 0.05),
                   sampler_fraction=0.03)
        whole = dict(cfg, trace_compact_fraction=(1.0,) * 4, sampler_fraction=1.0)
    else:
        cfg = dict(BASE, trace_compact_after=(6, 10), trace_compact_fraction=(0.2, 0.1),
                   sampler_fraction=0.06)
        whole = dict(cfg, trace_compact_fraction=(1.0, 1.0), sampler_fraction=1.0)
    coarse = name == "bench"
    r_j, r_t = _trace_both(fns, cfg, 384, coarse)
    assert int(r_t.trace_overflow) == int(r_j.trace_overflow) > 0
    assert int(r_t.sampler_overflow) == int(r_j.sampler_overflow) > 0
    _compare(r_j, r_t, fns)
    _, _, t_fine, t_coarse, _ = fns
    cam, d, gt = (torch.from_numpy(a) for a in _fan(384))
    with torch.no_grad():
        grown, ref = (trt.ray_trace(t_fine, cam, d, gt, None,
                                    trt.RayTracingConfig(**c), training=False,
                                    sdf_fn_coarse=t_coarse if coarse else None,
                                    grow=g) for c, g in ((cfg, True), (whole, False)))
    assert int(grown.trace_overflow) == int(grown.sampler_overflow) == 0
    hit = ref.network_object_mask
    assert torch.equal(grown.network_object_mask, hit) and bool(hit.any())
    assert float((grown.dists - ref.dists)[hit].abs().max()) <= 1e-4


def test_march_plain_equals_the_loop(fns):
    """A fixed count of `body_fused` equals the while loop: finished rays
    take zero moves, so the march and the loop give the same state."""
    _, _, t_fine, _, _ = fns
    cfg = trt.RayTracingConfig(**dict(BENCH, n_steps=16))
    cam, d, gt = (torch.from_numpy(a) for a in _fan(256, seed=3))
    with torch.no_grad():
        a = trt.ray_trace(t_fine, cam, d, gt, None, cfg, training=False)
        b = trt.ray_trace(t_fine, cam, d, gt, None,
                          dataclasses.replace(cfg, trace_in_kernel=True),
                          training=False)
    for name in ("network_object_mask", "sampler_mask"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    torch.testing.assert_close(a.dists, b.dists, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Newton: the hybrid schedule
# ---------------------------------------------------------------------------

def test_hybrid_newton_matches_jax(fns):
    j_fine, j_coarse, t_fine, t_coarse, _ = fns
    rng = np.random.RandomState(9)
    pts = rng.uniform(-0.8, 0.8, (1, 400, 3)).astype(np.float32)
    mask = np.ones((1, 400), bool)
    kw = dict(max_iters=4, coarse_iters=8, coarse_tolerance=1e-3)
    j_res = j_newton(j_fine, jnp.asarray(pts), jnp.asarray(mask),
                     sdf_fn_coarse=j_coarse, **kw)
    t_res = project_points_newton(t_fine, torch.from_numpy(pts),
                                  torch.from_numpy(mask),
                                  sdf_fn_coarse=t_coarse, **kw)
    tm, jm = t_res.mask.numpy(), np.asarray(j_res.mask)
    assert jm.sum() > 0.9 * 400
    assert abs(int(tm.sum()) - int(jm.sum())) <= 4
    both = tm & jm
    err = np.abs(t_res.points.numpy() - np.asarray(j_res.points)).max(-1)[both]
    assert err.max() <= 1e-3 and np.mean(err <= 1e-5) >= 0.9


# ---------------------------------------------------------------------------
# One warm-up training step with an IGR decoder and the bench schedule
# ---------------------------------------------------------------------------

def test_warmup_step_igr_bench_schedule_matches_jax():
    from test_torch_train_step import HP, LOSS_KEYS, jax_step_draws

    data = make_synthetic_mvr(sphere_sdf(), n_views=4, image_size=16,
                              device="cpu")
    idx = np.array([0, 2])
    img, mask = data["img.rgb"][idx], data["img.mask"][idx]
    mats = data["camera_mat"][idx]
    jcam = JCam.create(R=mats[:, :3, :3], T=mats[:, 3, :3],
                       focal_length=data["focal_length"],
                       principal_point=data["principal_point"])
    tcam = cameras_from_matrices(mats, data["focal_length"],
                                 data["principal_point"], device="cpu")
    raytrace = {k: v for k, v in BENCH.items() if k != "coarse_trace_iters"}
    jdec = JSDF(hidden_size=32, n_layers=4, num_frequencies=0)
    jmodel = JCombined(jdec, cfg=JImplicitConfig(
        use_fused_mlp=True, coarse_trace_iters=6, raytrace=raytrace))
    params = {"decoder": _scaled_params(jdec, seed=3)}
    tmodel = CombinedModel(
        SDFField(hidden_size=32, n_layers=4, num_frequencies=0, device="cpu"),
        ImplicitConfig(use_fused_mlp=True, coarse_trace_iters=6,
                       raytrace=raytrace))
    tmodel.load_state_dict(params_from_jax(
        {"decoder": jax.tree.map(np.asarray, params["decoder"])},
        keep_weight_norm=True))
    assert tmodel.trace_sdf_fn_coarse().precision == "bf16"
    pixels, k_loss, draws = jax_step_draws(jax.random.key(5), 2, (16, 16))
    _, (j_metrics, *_r) = jax.jit(lambda p: j_compute_loss(
        jmodel, p, None, None, pixels, jnp.asarray(img), jnp.asarray(mask),
        jcam, k_loss, {k: jnp.float32(v) for k, v in HP.items()},
        project=False, n_eikonal_points=draws.eikonal.shape[1]))(params)
    _, t_metrics, _, _, _ = compute_loss(
        tmodel, None, None, draws.pixels, torch.from_numpy(img),
        torch.from_numpy(mask), tcam, draws.eikonal, draws.u_minsdf, HP,
        project=False)
    assert float(j_metrics["n_iso"]) > 0
    assert abs(float(t_metrics["n_iso"]) - float(j_metrics["n_iso"])) <= 2
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(t_metrics[k].detach()),
                                   float(j_metrics[k]), rtol=1e-3, err_msg=k)
    assert int(t_metrics["overflow_trace"]) == int(j_metrics["overflow_trace"])


def test_bench_runs_on_cpu():
    """`isopoints_torch.bench` end to end at a tiny size on the CPU (the
    fused callables run their plain versions): the fit lowers the loss, the
    trace and the three projections report their numbers."""
    from isopoints_torch import bench

    out = bench.run("cpu", n_rays=512, n_points=128, fit_steps=4,
                    fit_points=256, reps=1, log=lambda m: None)
    assert np.isfinite(out["trace_ms"]) and out["rays_per_s"] > 0
    assert out["result"].dists.shape == (1, 512)
    assert set(out["projections"]) == {"f32", "bf16", "hybrid"}
    assert all(0.0 <= p["converged"] <= 1.0 for p in out["projections"].values())
    assert bench.bench_config().sphere_tracing_iters == 21


# ---------------------------------------------------------------------------
# The "uni" arm's schedule on a SIREN decoder
# ---------------------------------------------------------------------------

# configs/ablation_compound_uni.yml:17-41 (n_steps cut to 48 for the CPU)
UNI = dict(sphere_tracing_iters=21, trace_compact_after=(8, 12),
           trace_compact_fraction=(0.8, 0.55), sampler_fraction=0.5,
           coarse_trace_iters=6, sampler_coarse=True,
           sampler_coarse_margin=2e-3, coarse_stall_on_cross=True,
           fused_backstep=True, trace_gate_end_front=True,
           sampler_in_kernel=True, n_steps=48)


@pytest.fixture(scope="module")
def siren_fns():
    """A 2x64 SIREN fitted to the r = 0.6 sphere: JAX `highest` and `bf16`
    fused callables (interpret mode) and the port's f32 and bf16 ones."""
    from isopoints_tpu.models.fields import SirenField as JSiren
    from isopoints_tpu.ops.pallas_mlp import make_fused_siren_sdf as jax_siren
    from isopoints_torch.models.fields import SirenField
    field = SirenField(hidden_size=64, n_layers=2,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.Adam(field.parameters(), lr=1e-3)
    rng = np.random.RandomState(0)
    for _ in range(200):
        x = torch.from_numpy(rng.uniform(-1, 1, (1024, 3)).astype(np.float32))
        loss = ((field(x) - (x.norm(dim=-1) - 0.6)) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = {"layers": [{"w": l.weight.detach().numpy().copy(),
                          "b": l.bias.detach().numpy().copy()}
                         for l in field.layers]}
    return (jax_siren(jfield, params, interpret=True, precision="highest")[0],
            jax_siren(jfield, params, interpret=True, precision="bf16")[0],
            fused_mlp.make_fused_siren_sdf(field),
            fused_mlp.make_fused_siren_sdf(field, "bf16"), field)


@pytest.mark.parametrize("in_kernel", [False, True])
def test_siren_uni_schedule_matches_jax(siren_fns, in_kernel):
    """The uni arm's schedule at 1024 rays; with `trace_in_kernel` the
    compacted stages run the SIREN march's plain version."""
    cfg = dict(UNI, trace_in_kernel=in_kernel)
    r_j, r_t = _trace_both(siren_fns, cfg, 1024)
    _compare(r_j, r_t, siren_fns)
    assert int(r_t.trace_overflow) == int(r_t.sampler_overflow) == 0
    assert (fused_mlp.KERNEL.launches == fused_sampler.KERNEL.launches
            == fused_trace.KERNEL.launches == 0)


def test_siren_march_plain_equals_the_loop(siren_fns):
    """On a SIREN callable too, the march (`trace_in_kernel`, here its plain
    version over the callable's values) gives the loop's state exactly."""
    _, _, t_fine, t_coarse, _ = siren_fns
    cfg = trt.RayTracingConfig(**dict(UNI, n_steps=16))
    cam, d, gt = (torch.from_numpy(a) for a in _fan(256, seed=3))
    with torch.no_grad():
        a = trt.ray_trace(t_fine, cam, d, gt, None, cfg, training=False,
                          sdf_fn_coarse=t_coarse)
        b = trt.ray_trace(t_fine, cam, d, gt, None,
                          dataclasses.replace(cfg, trace_in_kernel=True),
                          training=False, sdf_fn_coarse=t_coarse)
    for name in ("network_object_mask", "sampler_mask"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    torch.testing.assert_close(a.dists, b.dists, atol=0, rtol=0)
    assert 0 < int(a.network_object_mask.sum()) < 256
