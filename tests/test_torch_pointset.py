"""Port parity: the point-set library against the JAX package, on the CPU.

`ops/points.py` (`bbox_diag`, `remove_outliers`, `wlop`,
`resample_uniformly`, `ear_lop_move`), `ops/imls.py`
(`project_to_latent_surface`) and `models/levelset.py`
(`edge_aware_upsample`, `project_points`' midpoint and edge-aware
upsampling branches, the unseeded WLOP bootstrap of
`sample_uniform_iso_points`). The port's kNN on CPU tensors is its plain
version. Inputs are made with numpy from a seed; JAX's own random draws
(WLOP's jitter, the bootstrap's cube points) are drawn from its key and
handed to the port as tensors.

Tolerances. Single-pass ops (the diagonal, the outlier mask, the EAR move,
the latent projection, one WLOP round): masks equal, points within 1e-5.
Looped ops: WLOP's three rounds within 1e-4; the upsampling rounds and the
bootstrap as point sets with equal counts: each of JAX's valid points has
a port point within 1e-5 (at least 90% of them) and within 1e-4 (at least
98%). The first insertion rounds agree slot for slot; later rounds rank
near-equal priorities of seeds that came out of the Newton and repulsion
rounds a few ulp apart, so an insert can land in another slot or at
another of two near-equal midpoints (tests/test_torch_levelset.py states
the same for the seeded resample).
"""

import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from isopoints_tpu.models import levelset as JL
from isopoints_tpu.ops import imls as JI
from isopoints_tpu.ops import points as JP
from isopoints_torch.models import levelset as TL
from isopoints_torch.ops import imls as TI
from isopoints_torch.ops import knn
from isopoints_torch.ops import points as TP

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_levelset import _cloud, _sdfs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = lambda a: torch.from_numpy(np.array(a))
J = jnp.asarray


def _noisy_sphere(seed, n=500, b=2, noise=0.01):
    rng = np.random.RandomState(seed)
    v = rng.randn(b, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = (0.5 * v + noise * rng.randn(b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) < 0.9
    return pts, v.astype(np.float32), mask


def _assert_same_set(t_pts, t_mask, j_pts, j_mask, share5=0.9, share4=0.98):
    """Equal counts a cloud; each of JAX's valid points near a port point."""
    t_pts, t_mask = t_pts.numpy(), t_mask.numpy()
    j_pts, j_mask = np.asarray(j_pts), np.asarray(j_mask)
    np.testing.assert_array_equal(t_mask.sum(-1), j_mask.sum(-1))
    for b in range(t_pts.shape[0]):
        d, _ = cKDTree(t_pts[b][t_mask[b]]).query(j_pts[b][j_mask[b]])
        assert np.mean(d <= 1e-5) >= share5, np.mean(d <= 1e-5)
        assert np.mean(d <= 1e-4) >= share4, np.mean(d <= 1e-4)


def test_bbox_diag_matches_jax():
    pts, _, mask = _noisy_sphere(0)
    np.testing.assert_allclose(TP.bbox_diag(T(pts), T(mask)).numpy(),
                               np.asarray(JP._bbox_diag(J(pts), J(mask))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["planted blob", "noisy sphere"])
def test_remove_outliers_matches_jax(case):
    """The JAX test's plane with an isotropic blob (tests/test_ops.py:154)
    at its k of 8, and a noisy sphere at the default k of 16."""
    rng = np.random.RandomState(3)
    if case == "planted blob":
        plane = np.concatenate([rng.rand(80, 2), np.zeros((80, 1))], -1)
        blob = rng.randn(20, 3) * 0.05 + [0.5, 0.5, 1.0]
        pts = np.concatenate([plane, blob]).astype(np.float32)[None]
        mask, k = np.ones((1, 100), bool), 8
    else:
        pts, _, mask = _noisy_sphere(3, noise=0.02)
        k = 16
    jm = np.asarray(JP.remove_outliers(J(pts), J(mask), neighborhood_size=k))
    tm = TP.remove_outliers(T(pts), T(mask), neighborhood_size=k).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert 0 < jm.sum() < mask.sum()
    if case == "planted blob":
        assert jm[0, :80].sum() > 70 and jm[0, 80:].sum() < 10


@pytest.mark.parametrize("iters,tol", [(1, 1e-5), (3, 1e-4)])
def test_wlop_matches_jax(iters, tol):
    pts, _, mask = _noisy_sphere(1)
    key = jax.random.key(3)
    s = int(np.ceil(pts.shape[1] * 0.5))
    noise = np.asarray(jax.random.normal(key, (2, s, 3)))
    jx, jxm = JP.wlop(J(pts), J(mask), key, iters=iters)
    tx, txm = TP.wlop(T(pts), T(mask), T(noise), iters=iters)
    np.testing.assert_array_equal(txm.numpy(), np.asarray(jxm))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=tol, rtol=0)
    assert knn.KERNEL.launches == 0


def test_resample_uniformly_matches_jax():
    pts, _, mask = _noisy_sphere(2)
    key = jax.random.key(4)
    s = int(np.ceil(pts.shape[1] * 0.5))
    noise = np.asarray(jax.random.normal(key, (2, s, 3)))
    jr, jrm = JP.resample_uniformly(J(pts), J(mask), key)
    tr, trm = TP.resample_uniformly(T(pts), T(mask), T(noise))
    np.testing.assert_array_equal(trm.numpy().sum(-1), mask.sum(-1))
    _assert_same_set(tr, trm, jr, jrm)


def test_ear_lop_move_matches_jax():
    pts, nrm, mask = _noisy_sphere(5)
    je = JP.ear_lop_move(J(pts), J(nrm), J(mask))
    te = TP.ear_lop_move(T(pts), T(nrm), T(mask))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(te.numpy()[~mask], pts[~mask])
    assert np.abs(te.numpy() - pts)[mask].max() > 1e-4      # the points moved


def test_project_to_latent_surface_matches_jax():
    pts, nrm, mask = _noisy_sphere(6)
    jl = JI.project_to_latent_surface(J(pts), J(nrm), J(mask))
    tl = TI.project_to_latent_surface(T(pts), T(nrm), T(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    # the projection moves the noisy points toward the sphere
    r0 = np.abs(np.linalg.norm(pts, axis=-1) - 0.5)[mask]
    r1 = np.abs(np.linalg.norm(tl.numpy(), axis=-1) - 0.5)[mask]
    assert np.median(r1) < np.median(r0)


def test_projection_config_edge_fields_match_jax():
    for kw in ({}, {"sharpness_angle": 20.0, "repulsion_mu": 0.4}):
        j, t = JL.ProjectionConfig(**kw), TL.ProjectionConfig(**kw)
        for name in ("sharpness_angle", "edge_sensitivity", "repulsion_mu",
                     "upsample_ratio", "sharpness_sigma"):
            assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("kind", ["sphere", "siren"])
def test_edge_aware_upsample_matches_jax(kind):
    j_sdf, t_sdf = _sdfs(kind)
    pts, mask = _cloud(4, 300)
    pj = JL.project_points_newton(j_sdf, J(pts), J(mask))
    ju, jum = JL.edge_aware_upsample(j_sdf, pj.points, pj.mask, 400,
                                     JL.ProjectionConfig())
    tu, tum = TL.edge_aware_upsample(t_sdf, T(pj.points), T(pj.mask), 400,
                                     TL.ProjectionConfig())
    # the default target: ceil(1.5 n) within the capacity
    assert int(tum.sum()) == min(400, int(np.ceil(1.5 * int(pj.mask.sum()))))
    _assert_same_set(tu, tum, ju, jum)


@pytest.mark.parametrize("edge_aware", [False, True], ids=["midpoint", "edge-aware"])
@pytest.mark.parametrize("kind", ["sphere", "siren"])
def test_project_points_upsampling_matches_jax(kind, edge_aware):
    """Newton, one repulsion round, the upsampling back to the input's
    count (midpoint: 31 neighbours, k > 16), the 10-iteration projection."""
    j_sdf, t_sdf = _sdfs(kind)
    pts, mask = _cloud(4, 300)
    kw = dict(skip_upsampling=False, edge_aware=edge_aware)
    jr = JL.project_points(j_sdf, J(pts), J(mask), JL.ProjectionConfig(), **kw)
    tr = TL.project_points(t_sdf, T(pts), T(mask), TL.ProjectionConfig(), **kw)
    plain = TL.project_points(t_sdf, T(pts), T(mask))
    # the sphere keeps every point; on the SIREN the upsampling adds back
    # what the projections dropped
    assert int(tr.mask.sum()) >= int(plain.mask.sum())
    if kind == "siren":
        assert int(tr.mask.sum()) > int(plain.mask.sum())
    _assert_same_set(tr.points, tr.mask, jr.points, jr.mask)


@pytest.mark.parametrize("kind", ["sphere", "siren"])
def test_unseeded_bootstrap_matches_jax(kind):
    """Cube seeds (4n) → project → WLOP at ratio 1/4 → project → midpoint
    upsampling to n → project, on JAX's cube and jitter draws."""
    j_sdf, t_sdf = _sdfs(kind)
    n = 200
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    cube = np.asarray(jax.random.uniform(k1, (1, 4 * n, 3)))
    noise = np.asarray(jax.random.normal(k2, (1, n, 3)))
    jb = JL.sample_uniform_iso_points(j_sdf, n, key)
    tb = TL.sample_uniform_iso_points(t_sdf, n, None, cube_u=T(cube),
                                      wlop_noise=T(noise))
    assert tb.points.shape == (1, n, 3)
    assert int(tb.mask.sum()) >= 0.95 * n
    _assert_same_set(tb.points, tb.mask, jb.points, jb.mask)
    with pytest.raises(ValueError, match="cube_u or a generator"):
        TL.sample_uniform_iso_points(t_sdf, n, None)
    # with a generator instead of the draws
    g = torch.Generator().manual_seed(0)
    tg = TL.sample_uniform_iso_points(t_sdf, n, None, generator=g)
    assert int(tg.mask.sum()) >= 0.95 * n
