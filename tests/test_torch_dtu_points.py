"""Port parity of the DTU point-cloud workload's pieces against the JAX
package, on the CPU: `pinverse`, the dense and grid radius searches,
`denoise_normals_bilateral`, `PointCloud.normalize_to_box` and the three
iso-point weight functions (the refresh's projection and the data normals:
tests/test_torch_dtu_refresh.py).

Inputs are made with numpy from seeds and handed to both packages.

Tolerances. Exact (equal): the radius searches' index sets, masks and
distances (the squared distances as fma chains, as XLA's CPU build forms
them), the weights' neighbour choices, the normalisation. `pinverse` within
1e-5 of the largest entry (two SVD routines). The bilateral denoising's
normals within 1e-5. The weights within 1e-5 absolute, the heat kernel's
within 1e-3 on 99% of the points (a pseudo-inverse of near-singular Gram
matrices, cut at 1e-6 of the largest singular value by two SVD routines).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.cloud import PointCloud as JCloud
from isopoints_tpu.ops import neighbors as jn
from isopoints_tpu.ops.points import denoise_normals_bilateral as j_denoise
from isopoints_tpu.utils.mathutils import pinverse as j_pinverse
from isopoints_tpu.workloads import dtu_points as jw
from isopoints_torch.core.cloud import PointCloud
from isopoints_torch.ops import knn
from isopoints_torch.ops.points import denoise_normals_bilateral
from isopoints_torch.utils.mathutils import pinverse
from isopoints_torch.workloads import dtu_points as tw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.from_numpy(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


# ---------------------------------------------------------------------------
# pinverse
# ---------------------------------------------------------------------------

def _matrices(kind, rng):
    if kind == "random":
        return rng.normal(size=(64, 8, 8)).astype(np.float32)
    if kind == "rank 5":
        a = rng.normal(size=(64, 8, 5)) @ rng.normal(size=(64, 5, 8))
        return a.astype(np.float32)
    if kind == "symmetric, masked rows":   # the heat kernel's Gram matrices
        f = rng.normal(size=(64, 8, 6)) * 0.3
        km = np.exp(-np.sum((f[:, :, None] - f[:, None]) ** 2, -1))
        keep = rng.uniform(size=(64, 8)) < 0.7
        return (km * keep[:, :, None] * keep[:, None, :]).astype(np.float32)
    return np.zeros((64, 8, 8), np.float32)


@pytest.mark.parametrize("kind", ["random", "rank 5", "symmetric, masked rows",
                                  "all zero"])
def test_pinverse_matches_jax(kind):
    m = _matrices(kind, np.random.RandomState(3))
    got = pinverse(T(m)).numpy()
    ref = np.asarray(j_pinverse(J(m)))
    if kind == "all zero":
        assert not got.any() and not ref.any()
        return
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(got - ref) <= 1e-5 * np.maximum(scale, 1.0))


# ---------------------------------------------------------------------------
# radius searches
# ---------------------------------------------------------------------------

def _search_case(name):
    """(query, points, query mask, points mask, exclude_self) with B = 2."""
    rng = np.random.RandomState(11)
    pts = rng.uniform(-0.5, 0.5, (2, 3000, 3)).astype(np.float32)
    if name == "masked points and queries":
        q = rng.uniform(-0.6, 0.6, (2, 700, 3)).astype(np.float32)
        return (q, pts, rng.uniform(size=(2, 700)) < 0.8,
                rng.uniform(size=(2, 3000)) < 0.8, False)
    if name == "self-excluded, masked":
        m = rng.uniform(size=(2, 3000)) < 0.85
        return pts, pts, m, m, True
    if name == "no valid point":
        q = rng.uniform(-0.6, 0.6, (2, 100, 3)).astype(np.float32)
        return q, pts, np.ones((2, 100), bool), np.zeros((2, 3000), bool), False
    # a lattice: many exactly equal distances, ties in candidate order
    g = np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
    g = (g.reshape(-1, 3) / 16.0).astype(np.float32)
    g = np.stack([g, g[rng.permutation(len(g))]])
    return g, g, np.ones(g.shape[:2], bool), np.ones(g.shape[:2], bool), True


CASES = ["masked points and queries", "self-excluded, masked", "no valid point",
         "integer lattice"]


def _assert_same(res, jres):
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(res.mask.numpy(), np.asarray(jres.mask))
    np.testing.assert_array_equal(res.dists.numpy(), np.asarray(jres.dists))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k,max_per_cell", [(8, 64), (16, 3), (40, 1)])
def test_grid_radius_search_matches_jax(case, k, max_per_cell):
    """The grid forced at small sizes; max_per_cell 3 and 1 overflow cells
    (their extra candidates dropped), k = 40 exceeds 27 candidates at one
    slot a cell (padded with -1 / 1e10); a small block size splits the
    queries."""
    q, p, qm, pm, excl = _search_case(case)
    r = 0.09
    res = knn.grid_radius_search(T(q), T(p), r, T(qm), T(pm), k=k,
                                 max_per_cell=max_per_cell, block_size=333,
                                 exclude_self=excl)
    jres = jn.grid_radius_search(J(q), J(p), r, J(qm), J(pm), k=k,
                                 max_per_cell=max_per_cell, exclude_self=excl)
    _assert_same(res, jres)
    assert res.idx.shape[-1] == k
    if case != "no valid point":
        assert res.mask.any()


@pytest.mark.parametrize("case", CASES[:3])
@pytest.mark.parametrize("k", [1, 8])
def test_dense_radius_search_matches_jax(case, k):
    q, p, qm, pm, excl = _search_case(case)
    res = knn.radius_search(T(q), T(p), 0.07, T(qm), T(pm), k=k,
                            exclude_self=excl)
    jres = jn.radius_search(J(q), J(p), 0.07, J(qm), J(pm), k=k,
                            exclude_self=excl)
    _assert_same(res, jres)
    # the radius cut some of the k nearest, and kept some
    assert res.mask.any() == (case != "no valid point")


def test_radius_search_auto_route():
    """'auto' takes the grid above 32,768 database points, as JAX does:
    with one slot a cell the grid drops candidates that the kNN keeps."""
    rng = np.random.RandomState(5)
    p = rng.uniform(-1, 1, (1, knn.GRID_MIN + 1, 3)).astype(np.float32)
    q = p[:, :200]
    auto = knn.radius_search(T(q), T(p), 0.05, k=8, max_per_cell=1)
    grid = knn.grid_radius_search(T(q), T(p), 0.05, k=8, max_per_cell=1)
    dense = knn.radius_search(T(q), T(p), 0.05, k=8, method="dense")
    assert torch.equal(auto.idx, grid.idx)
    assert not torch.equal(auto.idx, dense.idx)
    small = knn.radius_search(T(q), T(p[:, :knn.GRID_MIN]), 0.05, k=8,
                              max_per_cell=1)
    assert torch.equal(small.idx, knn.radius_search(
        T(q), T(p[:, :knn.GRID_MIN]), 0.05, k=8, method="dense").idx)


# ---------------------------------------------------------------------------
# normals, the cloud's normalisation
# ---------------------------------------------------------------------------

def _sphere_cloud(n, seed, frac=0.9):
    rng = np.random.RandomState(seed)
    v = rng.normal(size=(1, n, 3))
    pts = (0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
           + 0.01 * rng.normal(size=(1, n, 3))).astype(np.float32)
    nrm = (v + 0.3 * rng.normal(size=(1, n, 3))).astype(np.float32)
    return pts, nrm, rng.uniform(size=(1, n)) < frac


def test_denoise_normals_bilateral_matches_jax():
    pts, nrm, mask = _sphere_cloud(1500, 2)
    got = denoise_normals_bilateral(T(pts), T(nrm), T(mask)).numpy()
    ref = np.asarray(j_denoise(J(pts), J(nrm), J(mask)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the valid points moved, the masked ones only normalised
    raw = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    assert np.abs(got - raw)[mask].max() > 0.1
    np.testing.assert_allclose(got[~mask], raw[~mask], atol=1e-6)


def test_normalize_to_box_matches_jax():
    rng = np.random.RandomState(4)
    pts = (rng.uniform(-3, 5, (2, 500, 3)) * [1.0, 0.3, 2.0]).astype(np.float32)
    mask = rng.uniform(size=(2, 500)) < 0.8
    pts[~mask] = 1e6     # masked points lie far out and do not count
    pc, c, s = PointCloud.create(T(pts), mask=T(mask)).normalize_to_box(1.5)
    jpc, jc, js = JCloud.create(points=J(pts), mask=J(mask)).normalize_to_box(1.5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pc.points.numpy(), np.asarray(jpc.points))
    lo, hi = PointCloud.create(T(pts), mask=torch.zeros(2, 500, dtype=torch.bool)
                               ).bounding_box()
    assert (lo == torch.finfo(torch.float32).max).all()
    assert (hi == -torch.finfo(torch.float32).max).all()


# ---------------------------------------------------------------------------
# the iso-point weights
# ---------------------------------------------------------------------------

def _weights_inputs():
    rng = np.random.RandomState(31)
    iso, iso_n, iso_m = _sphere_cloud(800, 6, frac=0.85)
    iso_g = iso_n * rng.uniform(0.5, 2.0, (1, 800, 1)).astype(np.float32)
    surf, surf_n, _ = _sphere_cloud(1000, 7)
    surf = surf + rng.normal(scale=0.03, size=surf.shape).astype(np.float32)
    return surf, surf_n, iso, iso_g, iso_m


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_weights_match_jax(mode):
    surf, surf_n, iso, iso_g, iso_m = _weights_inputs()
    got = tw.WEIGHT_FNS[mode](T(surf), T(surf_n), T(iso), T(iso_g), T(iso_m)).numpy()
    jfn = {1: jw.iso_bilateral_weights, 2: jw.laplacian_weights,
           3: jw.heat_kernel_weights}[mode]
    ref = np.asarray(jfn(J(surf), J(surf_n), J(iso), J(iso_g), J(iso_m)))
    assert got.shape == ref.shape == (1, 1000)
    # the neighbour choices: the radius searches the weights make
    radius, k = {1: (0.1, 1), 2: (0.15, 1), 3: (0.15, 8)}[mode]
    res = knn.radius_search(T(surf), T(iso), radius, points_mask=T(iso_m), k=k)
    jres = jn.radius_search(J(surf), J(iso), radius, points_mask=J(iso_m), k=k)
    _assert_same(res, jres)
    assert 0.2 < (ref > 0).mean() and ref.max() > 0.5
    if mode < 3:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        close = np.abs(got - ref) <= 1e-3
        assert close.mean() >= 0.99, (close.mean(), np.abs(got - ref).max())
    # no weight without an iso-point in range
    assert np.all(got[~res.mask.numpy()[..., 0]] == 0) if mode < 3 else True


def test_local_frames_in_chunks_equal_one_call(monkeypatch):
    """The frames of a batch wider than `EIGH_CHUNK` (a million data points)
    come from several eigh calls: bit-equal to one call."""
    from isopoints_torch.utils import mathutils
    rng = np.random.RandomState(12)
    pts = T(rng.normal(size=(1, 500, 3)).astype(np.float32))
    nn = T(rng.normal(size=(1, 500, 8, 3)).astype(np.float32))
    m = T(rng.uniform(size=(1, 500, 8)) < 0.8)
    whole = mathutils.local_coord_frames(pts, nn, m)
    monkeypatch.setattr(mathutils, "EIGH_CHUNK", 37)
    parts = mathutils.local_coord_frames(pts, nn, m)
    assert torch.equal(parts[0], whole[0]) and torch.equal(parts[1], whole[1])
