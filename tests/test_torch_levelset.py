"""Port parity: Newton projection, repulsion resampling, the seeded uniform
resample, the cube intersection and the scheduler's projection schedules
against the JAX package, on the CPU.

The SDFs are an analytic sphere (radius 0.5) and a small SIREN (64 wide,
2 hidden layers) initialised by the JAX package and converted. The port
runs the SIREN through the fused-MLP wrapper, which on CPU tensors is the
plain version. Inputs and the resample's subsample draws are made with
numpy from a seed and handed to both packages.

Tolerances. Newton projection and the resample: valid counts within 1%
of the points (a point whose |f| lands within round-off of the 5e-5
tolerance converges in one package and not in the other) and points
within 1e-5 on the points both keep; the resample's output compared as a
point set (each of JAX's valid points has a port point within 1e-5 for at
least 98% of them): the midpoint upsampling is bit-identical on equal
seeds (tests/test_torch_knn.py), but its seeds come out of the Newton
projection and the repulsion a few ulp apart, which can swap two
near-equal clearances and so the slot order of later inserts. Cube intersection:
equal hits, points within 1e-6. Schedules: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.levelset import ProjectionConfig as JProjCfg
from isopoints_tpu.models.levelset import project_points_newton as j_newton
from isopoints_tpu.models.levelset import resample_repulsion as j_repulsion
from isopoints_tpu.models.levelset import (
    sample_uniform_iso_points as j_uniform,
)
from isopoints_tpu.models.raytracing import intersection_with_unit_cube as j_cube
from isopoints_tpu.training.scheduler import TrainerScheduler as JScheduler
from isopoints_torch.convert import params_from_jax
from isopoints_torch.models.fields import SirenField
from isopoints_torch.models.levelset import (ProjectionConfig, project_points,
                                             project_points_newton,
                                             resample_repulsion,
                                             sample_uniform_iso_points)
from isopoints_torch.models.raytracing import intersection_with_unit_cube
from isopoints_torch.ops import fused_mlp, knn
from isopoints_torch.training.scheduler import TrainerScheduler


def _sdfs(kind):
    """(JAX sdf, port sdf) of the same function."""
    if kind == "sphere":
        return (lambda x: jnp.linalg.norm(x, axis=-1) - 0.5,
                lambda x: torch.linalg.norm(x, dim=-1) - 0.5)
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(1))
    field = SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    field.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()})
    return (lambda x: jfield.sdf(params, x),
            fused_mlp.make_fused_siren_sdf(field))


def _cloud(seed, n, scale=0.75, frac=0.9):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-scale, scale, (1, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(1, n)) < frac
    return pts, mask


def _assert_projection_close(t_res, j_res, n):
    tm, jm = t_res.mask.numpy(), np.asarray(j_res.mask)
    assert jm.sum() > 0.3 * n
    assert abs(int(tm.sum()) - int(jm.sum())) <= max(2, 0.01 * n)
    both = tm & jm
    np.testing.assert_allclose(t_res.points.numpy()[both],
                               np.asarray(j_res.points)[both], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind,iters", [("sphere", 10), ("siren", 10),
                                        ("siren", 3)])
def test_newton_projection_matches_jax(kind, iters):
    j_sdf, t_sdf = _sdfs(kind)
    pts, mask = _cloud(2, 400)
    j_res = j_newton(j_sdf, jnp.asarray(pts), jnp.asarray(mask), max_iters=iters)
    t_res = project_points_newton(t_sdf, torch.from_numpy(pts),
                                  torch.from_numpy(mask), max_iters=iters)
    _assert_projection_close(t_res, j_res, 400)
    # masked points never move
    np.testing.assert_array_equal(t_res.points.numpy()[~mask], pts[~mask])
    assert fused_mlp.KERNEL.launches == 0


def test_resample_repulsion_matches_jax():
    j_sdf, t_sdf = _sdfs("siren")
    pts, mask = _cloud(3, 500)
    pj = j_newton(j_sdf, jnp.asarray(pts), jnp.asarray(mask))
    cfg, jcfg = ProjectionConfig(sample_iters=2), JProjCfg(sample_iters=2)
    j_res = j_repulsion(j_sdf, pj.points, pj.normals, pj.mask, jcfg)
    t_res = resample_repulsion(t_sdf, torch.from_numpy(np.asarray(pj.points)),
                               torch.from_numpy(np.asarray(pj.normals)),
                               torch.from_numpy(np.asarray(pj.mask)), cfg)
    _assert_projection_close(t_res, j_res, 500)
    assert knn.KERNEL.launches == 0


@pytest.mark.parametrize("n_seed,n_points", [(300, 200), (160, 256)])
def test_sample_uniform_iso_points_seeded_matches_jax(n_seed, n_points):
    """The trainer's resample: seeded from the current cloud, shrinking
    (random subsample of the seeds) or growing (midpoint upsampling)."""
    j_sdf, t_sdf = _sdfs("siren")
    pts, mask = _cloud(4, n_seed)
    key = jax.random.key(7)
    u = np.asarray(jax.random.uniform(jax.random.split(key)[1], mask.shape))
    j_res = j_uniform(j_sdf, n_points, key, init_points=jnp.asarray(pts),
                      init_mask=jnp.asarray(mask))
    t_res = sample_uniform_iso_points(t_sdf, n_points, torch.from_numpy(pts),
                                      torch.from_numpy(mask),
                                      subsample_u=torch.from_numpy(u))
    tm, jm = t_res.mask.numpy()[0], np.asarray(j_res.mask)[0]
    assert t_res.points.shape == (1, n_points, 3)
    assert jm.sum() > 0.5 * n_points
    assert abs(int(tm.sum()) - int(jm.sum())) <= max(2, 0.01 * n_points)
    d, _ = cKDTree(t_res.points.numpy()[0][tm]).query(
        np.asarray(j_res.points)[0][jm])
    assert np.mean(d <= 1e-5) >= 0.98


def test_project_points_branches():
    _, t_sdf = _sdfs("sphere")
    pts, mask = (torch.from_numpy(a) for a in _cloud(5, 120))
    plain = project_points(t_sdf, pts, mask, skip_resampling=True)
    ref = project_points_newton(t_sdf, pts, mask)
    assert torch.equal(plain.points, ref.points) and torch.equal(plain.mask, ref.mask)
    # the repulsion branch: Newton, then the repulsion resampling
    rep = project_points(t_sdf, pts, mask, skip_resampling=False)
    ref = resample_repulsion(t_sdf, *ref, ProjectionConfig())
    assert torch.equal(rep.points, ref.points) and torch.equal(rep.mask, ref.mask)
    # the upsampling branch: Newton, then the midpoint upsampling (31
    # neighbours) back to the input's count, then a 10-iteration projection
    # (tests/test_torch_pointset.py holds both upsamplings against JAX)
    from isopoints_torch.ops.points import midpoint_upsample
    up = project_points(t_sdf, pts, mask, skip_resampling=True,
                        skip_upsampling=False)
    ref = project_points_newton(t_sdf, pts, mask)
    ref = project_points_newton(t_sdf, *midpoint_upsample(
        ref.points, ref.mask, pts.shape[1], n_target=mask.sum(-1),
        neighborhood_size=31), max_iters=10)
    assert torch.equal(up.points, ref.points) and torch.equal(up.mask, ref.mask)
    # the unseeded bootstrap takes its draws or a generator
    with pytest.raises(ValueError, match="cube_u or a generator"):
        sample_uniform_iso_points(t_sdf, 64, None)
    boot = sample_uniform_iso_points(t_sdf, 64, None,
                                     generator=torch.Generator().manual_seed(0))
    assert boot.points.shape == (1, 64, 3) and int(boot.mask.sum()) >= 60


def test_intersection_with_unit_cube_matches_jax():
    rng = np.random.RandomState(6)
    cam = rng.uniform(-3, 3, (4, 1, 3)).astype(np.float32)
    dirs = rng.randn(4, 200, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    je, jx, jh = jax.jit(j_cube, static_argnums=2)(jnp.asarray(cam),
                                                   jnp.asarray(dirs), 2.0)
    te, tx, th = intersection_with_unit_cube(torch.from_numpy(cam),
                                             torch.from_numpy(dirs), 2.0)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 0.1 < th.numpy().mean() < 0.9
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [
    {},
    {"init_n_points_dss": 6000, "steps_n_points_dss": 4000,
     "limit_n_points_dss": 24000},
    {"steps_proj_tolerance": 500, "init_proj_max_iters": 10},
])
def test_projection_schedules_match_jax(kw):
    """n_points_dss, proj_max_iters and proj_tolerance at the iterations a
    trainer with warm_up_iters 500 / resample_every 500 resamples at."""
    t, j = TrainerScheduler(**kw), JScheduler(**kw)
    for it in (500, 1000, 1500, 2000, 4000, 8000, 12000):
        a, b = t.at(it), j.at(it)
        for k in ("n_points_dss", "proj_max_iters", "proj_tolerance"):
            assert a[k] == b[k], (it, k)
