"""Port parity: the certify-then-sweep sampler (`sampler_presweep`,
models/raytracing.py `_presweep_sampler`) against the JAX package on the
CPU.

- JAX's four `TestSamplerPresweep` cases (tests/test_raytracing.py) on the
  port: on the exact sphere and torus SDFs the presweep reproduces the
  port's dense sampler (hit masks equal, hit depths within 1e-5, overflow
  0); a dense buffer of 2/128 overflows and its overflowed rays are
  reported non-surface; the presweep composes with `sampler_fraction`.
- The port against JAX on the same fans and configs: hit masks equal,
  hit depths within 1e-5, overflow equal.
- A converted IGR field (test_torch_trace_schedule.py's, JAX's fused
  kernel in interpret mode at `highest` and `bf16`, the port's fused
  callables as their plain versions), with and without `sampler_coarse`,
  on the loop and on the in-kernel sampler's route: hit and sampler masks
  equal, hit depths within 1e-5, overflow equal. The certificate is a
  float comparison, so a ray whose min(|f_a|, |f_b|) sits within an ulp of
  L·seg could flip between two correct arithmetics; the test counts such
  rays and there are none on these fans.
- The roofline's evaluation count adds the presweep's, as bench.py's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.models import raytracing as jrt
from isopoints_torch import bench as tbench
from isopoints_torch.models import raytracing as trt
from test_torch_trace_schedule import _fan, fns  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_sphere(r=0.5):
    return lambda x: jnp.linalg.norm(x, axis=-1) - r


def t_sphere(r=0.5):
    return lambda x: torch.linalg.norm(x, dim=-1) - r


def j_torus(R=0.5, r=0.2):
    def f(x):
        q = jnp.stack([jnp.linalg.norm(x[..., :2], axis=-1) - R, x[..., 2]], -1)
        return jnp.linalg.norm(q, axis=-1) - r
    return f


def t_torus(R=0.5, r=0.2):
    def f(x):
        q = torch.stack([torch.linalg.norm(x[..., :2], dim=-1) - R, x[..., 2]], -1)
        return torch.linalg.norm(q, dim=-1) - r
    return f


def _ray_fan(n=128, seed=9, z=-2.5):
    """tests/test_raytracing.py's `_ray_fan`, as numpy arrays."""
    cam = jnp.broadcast_to(jnp.array([0.0, 0.0, z]), (1, n, 3))
    ang = jax.random.uniform(jax.random.key(seed), (1, n, 2),
                             minval=-0.3, maxval=0.3)
    d = jnp.stack([jnp.tan(ang[..., 0]), jnp.tan(ang[..., 1]),
                   jnp.ones((1, n))], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return np.array(cam), np.array(d), np.ones((1, n), bool)


def _port(f, cam, d, gt, **cfg):
    with torch.no_grad():
        return trt.ray_trace(f, torch.from_numpy(cam), torch.from_numpy(d),
                             torch.from_numpy(gt), None,
                             trt.RayTracingConfig(**cfg), training=False)


def _jax(f, cam, d, gt, **cfg):
    return jrt.ray_trace(f, jnp.asarray(cam), jnp.asarray(d), jnp.asarray(gt),
                         jax.random.key(1), jrt.RayTracingConfig(**cfg),
                         training=False)


def _same_hits(a_mask, a_dists, b_mask, b_dists, atol=1e-5):
    np.testing.assert_array_equal(a_mask, b_mask)
    np.testing.assert_allclose(a_dists[a_mask], b_dists[a_mask], atol=atol)


PRE = dict(sphere_tracing_iters=3, sampler_presweep=26,
           sampler_dense_fraction=0.99)

# JAX's four TestSamplerPresweep cases: (name, SDF, seed, presweep config,
# dense config)
CASES = [
    ("sphere", "sphere", 31, PRE, dict(sphere_tracing_iters=3)),
    ("torus", "torus", 32, PRE, dict(sphere_tracing_iters=3)),
    ("overflow", "torus", 33, dict(PRE, sampler_dense_fraction=2 / 128), None),
    ("sampler_fraction", "sphere", 34, dict(PRE, sampler_fraction=0.99),
     dict(sphere_tracing_iters=3, sampler_fraction=0.99)),
]
SDFS = {"sphere": (j_sphere(), t_sphere()), "torus": (j_torus(), t_torus())}


@pytest.mark.parametrize("name,sdf,seed,pre,dense", CASES,
                         ids=[c[0] for c in CASES])
def test_jax_presweep_cases_on_the_port(name, sdf, seed, pre, dense):
    """JAX's TestSamplerPresweep, each case run on the port."""
    _, tf = SDFS[sdf]
    cam, d, gt = _ray_fan(seed=seed)
    p = _port(tf, cam, d, gt, **pre)
    if dense is None:
        assert int(p.sampler_overflow) > 0
        hits = p.network_object_mask.numpy()
        if hits.sum():
            # overflowed rays are reported non-surface, not garbage
            assert np.abs(tf(p.points).numpy()[hits]).max() < 5e-3
        return
    ref = _port(tf, cam, d, gt, **dense)
    np.testing.assert_array_equal(ref.network_object_mask.numpy(),
                                  p.network_object_mask.numpy())
    if name != "sampler_fraction":
        _same_hits(ref.network_object_mask.numpy(), ref.dists.numpy(),
                   p.network_object_mask.numpy(), p.dists.numpy())
    if name == "sphere":
        assert int(p.sampler_overflow) == 0


@pytest.mark.parametrize("name,sdf,seed,pre,dense", CASES,
                         ids=[c[0] for c in CASES])
def test_presweep_matches_jax(name, sdf, seed, pre, dense):
    """The port against JAX on the same fan and config: hit masks equal,
    hit depths within 1e-5, overflow equal; the points of the hits too."""
    jf, tf = SDFS[sdf]
    cam, d, gt = _ray_fan(seed=seed)
    r_j, r_t = _jax(jf, cam, d, gt, **pre), _port(tf, cam, d, gt, **pre)
    hit = np.asarray(r_j.network_object_mask)
    _same_hits(hit, np.asarray(r_j.dists), r_t.network_object_mask.numpy(),
               r_t.dists.numpy())
    np.testing.assert_array_equal(np.asarray(r_j.sampler_mask),
                                  r_t.sampler_mask.numpy())
    assert int(r_t.sampler_overflow) == int(r_j.sampler_overflow)
    np.testing.assert_allclose(r_t.points.numpy()[hit],
                               np.asarray(r_j.points)[hit], atol=1e-5)


IGR = dict(sphere_tracing_iters=4, n_steps=32, sampler_presweep=9,
           sampler_dense_fraction=0.9)


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("in_kernel", [False, True])
def test_presweep_igr_field_matches_jax(fns, coarse, in_kernel):  # noqa: F811
    """A converted IGR field, fine only or with the coarse (bf16) sweep, on
    the loop's sampler and on the in-kernel sampler's route."""
    j_fine, j_coarse, t_fine, t_coarse, _ = fns
    cfg = dict(IGR, sampler_coarse=coarse, sampler_coarse_margin=2e-3 if coarse else 0.0,
               sampler_in_kernel=in_kernel)
    cam, d, gt = _fan(256, seed=5)
    r_j = jax.jit(lambda c, dd, g: jrt.ray_trace(
        j_fine, c, dd, g, jax.random.key(1), jrt.RayTracingConfig(**cfg),
        training=False, sdf_fn_coarse=j_coarse if coarse else None))(
            jnp.asarray(cam), jnp.asarray(d), jnp.asarray(gt))
    with torch.no_grad():
        r_t = trt.ray_trace(t_fine, torch.from_numpy(cam), torch.from_numpy(d),
                            torch.from_numpy(gt), None,
                            trt.RayTracingConfig(**cfg), training=False,
                            sdf_fn_coarse=t_coarse if coarse else None)
    hit = np.asarray(r_j.network_object_mask)
    smp = np.asarray(r_j.sampler_mask)
    assert 0 < hit.sum() < hit.size and smp.sum() > 0
    np.testing.assert_array_equal(smp, r_t.sampler_mask.numpy())
    _same_hits(hit, np.asarray(r_j.dists), r_t.network_object_mask.numpy(),
               r_t.dists.numpy())
    assert int(r_t.sampler_overflow) == int(r_j.sampler_overflow)
    # the certificate's near-ties on these rays: none (the presweep starts
    # from the trace's fronts, which the sampler sweeps between)
    assert _near_ties(t_coarse if coarse else t_fine, cam, d,
                      r_t.sampler_mask.numpy()) == 0


def _near_ties(fn, cam, d, sampler_mask, lip=2.0):
    """Rays whose certificate min(|f_a|, |f_b|) sits within 2 ulp of L·seg
    on some interval of the presweep grid over the bounding-sphere chord."""
    cam_t, d_t = torch.from_numpy(cam), torch.from_numpy(d)
    near, far, _ = trt.intersection_with_unit_sphere(cam_t, d_t)
    t_lo = torch.sum((near - cam_t) * d_t, -1)
    t_hi = torch.sum((far - cam_t) * d_t, -1)
    s1 = IGR["sampler_presweep"]
    ts = trt.fma(trt.linspace01(s1), (t_hi - t_lo)[..., None], t_lo[..., None])
    with torch.no_grad():
        f = fn(trt.fma(ts[..., None], d_t[..., None, :], cam_t[..., None, :])).numpy()
    lim = (lip * np.abs((t_hi - t_lo).numpy()) / (s1 - 1))[..., None].astype(np.float32)
    m = np.minimum(np.abs(f[..., :-1]), np.abs(f[..., 1:]))
    tie = np.any(np.abs(m - lim) <= 2 * np.spacing(lim), axis=-1)
    return int((tie & sampler_mask).sum())


def test_presweep_off_is_the_dense_sampler():
    """`sampler_presweep` 0, 1 or >= n_steps leaves the dense sampler."""
    cam, d, gt = _ray_fan(seed=31)
    ref = _port(t_sphere(), cam, d, gt, sphere_tracing_iters=3, n_steps=32)
    for s1 in (1, 32, 40):
        p = _port(t_sphere(), cam, d, gt, sphere_tracing_iters=3, n_steps=32,
                  sampler_presweep=s1, sampler_dense_fraction=0.01)
        assert torch.equal(p.dists, ref.dists)
        assert int(p.sampler_overflow) == 0


def test_roofline_counts_the_presweep():
    """bench.py:203-207's evaluations a ray with the presweep on."""
    base = tbench.bench_config()
    pre = dataclasses.replace(base, sampler_presweep=26,
                              sampler_dense_fraction=0.5)
    dims = [3, 256, 256, 256, 256, 1]
    per_eval = 2.0 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    n = 262_144
    for cfg in (base, pre):
        assert tbench.trace_roofline(cfg, n, 1.0).flops == per_eval * int(n * _evals(cfg))
    assert _evals(pre) - _evals(base) == pytest.approx(
        base.sampler_fraction * (26 + 0.5 * base.n_steps - base.n_steps))


def _evals(cfg):
    """bench.py:191-207 written out for the bench schedule."""
    stages, fr = cfg.trace_compact_after, cfg.trace_compact_fraction
    e = 2.0 * (stages[0] + 1)
    for a, nxt, f in zip(stages, list(stages[1:]) + [cfg.sphere_tracing_iters], fr):
        e += 2.0 * (nxt - a) * f
    sf = cfg.sampler_fraction
    if cfg.sampler_presweep >= 2:
        return e + sf * (cfg.sampler_presweep + cfg.sampler_dense_fraction
                         * cfg.n_steps + cfg.n_secant_steps)
    return e + sf * (cfg.n_steps + cfg.n_secant_steps)
