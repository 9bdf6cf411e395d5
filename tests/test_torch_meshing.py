"""Port parity: marching tetrahedra and the grid extraction
(isopoints_torch/utils/meshing.py, ops/native.py) against the JAX package's
utils/meshing.py, on analytic fields.

- The port's C++ sweep (its own copy of csrc/marching_tet.cpp, built with
  g++ here) against JAX's `marching_tetrahedra`, which runs the same source:
  vertices bit-equal, faces equal. The port's numpy plain version against
  JAX's numpy path (its native binding switched off in the test): bit-equal.
  The sweep against the plain version: the same faces up to the vertices'
  order, vertices within 2 float32 ulp of the grid's scale (the sweep forms
  them in float32, the plain version in float64).
- `eval_sdf_grid` with a chunk smaller than the grid: bit-equal to JAX's
  (the same float64 axes cast to float32, the same field arithmetic).
- One-stage extraction at 32: bit-equal on a sphere and a torus. Two-stage
  (coarse 24, fine 32), also on a tilted off-centre ellipsoid: faces equal,
  99.9% of the vertex coordinates within 2e-6 and all within 5e-5 (the
  rotation of the fine grid's points rounds otherwise than XLA's CPU dot).
- `largest_component` and `sample_points_from_mesh`: bit-equal.
- A failed build raises with the compiler's output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.ops import native as j_native
from isopoints_tpu.utils import meshing as jm
from isopoints_torch.ops import native
from isopoints_torch.utils import meshing as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_grid(r: int, radius: float = 0.55, center=(0.0, 0.0, 0.0)):
    ax = np.linspace(-1.0, 1.0, r)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    vals = np.linalg.norm(g - np.asarray(center), axis=-1) - radius
    return vals.astype(np.float32), (-1.0, -1.0, -1.0), [2.0 / (r - 1)] * 3


def torus(lib):
    norm = torch.linalg.norm if lib is torch else jnp.linalg.norm
    stack = torch.stack if lib is torch else jnp.stack

    def f(x):
        q = stack([norm(x[..., :2], **{"dim" if lib is torch else "axis": -1})
                   - 0.4, x[..., 2]], -1)
        return norm(q, **{"dim" if lib is torch else "axis": -1}) - 0.15
    return f


def sphere(lib):
    if lib is torch:
        return lambda x: torch.linalg.norm(x, dim=-1) - 0.5
    return lambda x: jnp.linalg.norm(x, axis=-1) - 0.5


def ellipsoid(lib):
    """An off-centre ellipsoid, tilted: its PCA frame is a rotation."""
    c = np.array([0.1, -0.05, 0.08], np.float32)
    if lib is torch:
        return lambda x: torch.linalg.norm(
            (x - torch.from_numpy(c)) * torch.tensor([1.0, 1.6, 2.5])
            + 0.3 * torch.flip(x, [-1]), dim=-1) - 0.5
    return lambda x: jnp.linalg.norm(
        (x - c) * jnp.asarray([1.0, 1.6, 2.5]) + 0.3 * jnp.flip(x, -1),
        axis=-1) - 0.5


@pytest.mark.parametrize("r", [24, 32])
def test_native_matches_jax(r):
    vals, origin, spacing = sphere_grid(r)
    v, f = tm.marching_tetrahedra(vals, origin, spacing)
    jv, jf = jm.marching_tetrahedra(vals, origin, spacing)
    assert len(f) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("r", [24, 32])
def test_plain_matches_jax_numpy_path(r, monkeypatch):
    vals, origin, spacing = sphere_grid(r, center=(0.1, -0.2, 0.05))
    monkeypatch.setattr(j_native, "marching_tetrahedra_native",
                        lambda *a, **k: None)
    jv, jf = jm.marching_tetrahedra(vals, origin, spacing)
    v, f = tm.marching_tetrahedra_plain(vals, origin, spacing)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("r", [24, 32])
def test_native_matches_plain_up_to_order(r):
    vals, origin, spacing = sphere_grid(r, radius=0.7, center=(0.2, 0.1, -0.1))
    v, f = tm.marching_tetrahedra(vals, origin, spacing)
    pv, pf = tm.marching_tetrahedra_plain(vals, origin, spacing)
    assert v.shape == pv.shape and f.shape == pf.shape
    # match vertices by position (each is on its own grid edge)
    order, porder = np.lexsort(v.T[::-1]), np.lexsort(pv.T[::-1])
    np.testing.assert_allclose(v[order], pv[porder], rtol=0, atol=2 * 1.2e-7)
    perm = np.empty(len(v), np.int64)
    perm[order] = porder
    tri = lambda faces: {tuple(np.roll(t, -int(np.argmin(t)))) for t in faces}
    assert tri(perm[f]) == tri(pf)


def test_empty_and_flat_grids():
    assert tm.marching_tetrahedra(np.ones((4, 4, 4), np.float32))[1].shape == (0, 3)
    assert tm.marching_tetrahedra(np.ones((1, 4, 4), np.float32))[0].shape == (0, 3)
    assert tm.marching_tetrahedra_plain(np.ones((4, 4, 4)))[1].shape == (0, 3)


@pytest.mark.parametrize("field", [sphere, torus])
def test_eval_sdf_grid_bit_equal(field):
    # 29³ = 24,389 points in chunks of 5000: 5 chunks, the last padded
    a = tm.eval_sdf_grid(field(torch), 29, (-1.0, -0.9, -1.1), (1.0, 0.8, 1.2),
                         chunk=5000, device="cpu")
    b = jm.eval_sdf_grid(field(jnp), 29, (-1.0, -0.9, -1.1), (1.0, 0.8, 1.2),
                         chunk=5000)
    assert a.dtype == np.float32 and a.shape == (29, 29, 29)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", [sphere, torus])
def test_extract_mesh_one_stage(field):
    v, f = tm.extract_mesh(field(torch), 32, device="cpu")
    jv, jf = jm.extract_mesh(field(jnp), 32)
    assert len(f) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("field", [sphere, torus, ellipsoid])
def test_extract_mesh_two_stage(field):
    v, f = tm.get_surface_high_res_mesh(field(torch), resolution=32,
                                        coarse_res=24, device="cpu")
    jv, jf = jm.get_surface_high_res_mesh(field(jnp), resolution=32,
                                          coarse_res=24)
    assert len(f) > 100
    np.testing.assert_array_equal(f, jf)
    # the fine grid's local->world rotation is a float32 fma chain here and
    # XLA's CPU dot there, which sums the three products in another order:
    # a point moves by ~1 ulp, a vertex by that plus its grid values'
    # difference over their slope, large where an edge crosses the surface
    # almost flat. Held: 99.9% of the coordinates within 2e-6, all within
    # 5e-5 (1/600 of the fine spacing); faces equal
    err = np.abs(v - jv)
    assert np.mean(err <= 2e-6) >= 0.999 and err.max() <= 5e-5, err.max()


def test_largest_component_bit_equal():
    # two spheres apart, the larger kept
    r = 32
    ax = np.linspace(-1.0, 1.0, r)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    vals = np.minimum(np.linalg.norm(g - [0.45, 0, 0], axis=-1) - 0.4,
                      np.linalg.norm(g + [0.55, 0, 0], axis=-1) - 0.25)
    vals = vals.astype(np.float32)
    v, f = tm.marching_tetrahedra(vals, (-1.0,) * 3, [2.0 / (r - 1)] * 3)
    kv, kf = tm.largest_component(v, f)
    jv, jf = jm.largest_component(v, f)
    assert 0 < len(kf) < len(f)
    np.testing.assert_array_equal(kv, jv)
    np.testing.assert_array_equal(kf, jf)
    assert kv[:, 0].min() > -0.1   # the larger sphere, about x = 0.45


def test_sample_points_from_mesh_bit_equal():
    vals, origin, spacing = sphere_grid(24)
    v, f = tm.marching_tetrahedra(vals, origin, spacing)
    for seed in (0, 3):
        p, n = tm.sample_points_from_mesh(v, f, 2000, seed=seed)
        jp, jn = jm.sample_points_from_mesh(v, f, 2000, seed=seed)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(n, jn)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native._build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
