"""Port parity: mesh evaluation (isopoints_torch/training/evaluation.py)
against the JAX package's training/evaluation.py, on the CPU (the kNN's
plain version).

- `chamfer_distance`, with and without normals, on clouds of different
  sizes: rtol 1e-5 (float32 means over a few thousand terms); chamfer_n
  also atol 1e-6 (1 − a mean near 1).
- `point_tri_sq_dists` on points placed in each Voronoi region of a
  triangle (inside, beyond each edge, beyond each vertex, and off the
  plane above each): equal to the exact distance within 1e-6, and to
  JAX's within rtol 1e-5 + atol 1e-7; the gradient in the points against
  `jax.grad` within rtol 1e-4 + atol 1e-6.
- `point_face_distance` with a chunk smaller than the point count (the
  pair cap forcing it), and on points within ~1e-3 of the mesh: rtol 1e-5
  against JAX's.
- `evaluate_mesh` in both directions (a GT mesh: `point_face`; GT points
  only: `point_face_rev`): rtol 1e-5 on every metric, chamfer_n as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.training import evaluation as je
from isopoints_tpu.utils.meshing import marching_tetrahedra as j_mt
from isopoints_torch.training import evaluation as te


# chamfer_n sums two 1 − mean|cos| terms with the means near 1: its error is
# that of the means, a few float32 ulp of 1 (6e-8 each)
ATOL = {"chamfer_p": 0.0, "chamfer_n": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphere_mesh(r=20, radius=0.5, center=(0.0, 0.0, 0.0)):
    ax = np.linspace(-1.0, 1.0, r)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    vals = (np.linalg.norm(g - np.asarray(center), axis=-1) - radius)
    return j_mt(vals.astype(np.float32), (-1.0,) * 3, [2.0 / (r - 1)] * 3)


def clouds(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(1500, 3)).astype(np.float32)
    y = (rng.normal(size=(2300, 3)) * 0.9 + 0.05).astype(np.float32)
    xn = rng.normal(size=(1500, 3)).astype(np.float32)
    yn = rng.normal(size=(2300, 3)).astype(np.float32)
    return x, y, xn, yn


@pytest.mark.parametrize("normals", [False, True])
def test_chamfer_matches_jax(normals):
    x, y, xn, yn = clouds()
    t = torch.from_numpy
    got = te.chamfer_distance(t(x), t(y), *( (t(xn), t(yn)) if normals else ()))
    ref = je.chamfer_distance(jnp.asarray(x), jnp.asarray(y),
                              *((jnp.asarray(xn), jnp.asarray(yn)) if normals
                                else ()))
    assert sorted(got) == sorted(ref) == (["chamfer_n", "chamfer_p"] if normals
                                          else ["chamfer_p"])
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=ATOL[k],
                                   err_msg=k)


def voronoi_points():
    """A triangle and points in each region of its plane's Voronoi
    partition (and lifted off the plane), with their exact distances."""
    a, b, c = np.array([0.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]), \
        np.array([0.2, 0.8, 0.0])
    up = np.array([0.0, 0.0, 1.0])
    pts, exact = [], []

    def add(p_plane, closest):
        for h in (0.0, 0.3, -0.7):
            p = p_plane + h * up
            pts.append(p)
            exact.append(np.sum((p - closest) ** 2))

    add((a + b + c) / 3, (a + b + c) / 3)                 # inside
    add(np.array([0.4, 0.3, 0.0]), np.array([0.4, 0.3, 0.0]))
    add(np.array([0.5, -0.4, 0.0]), np.array([0.5, 0.0, 0.0]))   # beyond ab
    for p0, p1 in ((a, c), (b, c)):                        # beyond ac, bc
        mid = 0.5 * (p0 + p1)
        e = p1 - p0
        n = np.array([e[1], -e[0], 0.0])
        n = n / np.linalg.norm(n)
        if np.dot(n, (a + b + c) / 3 - mid) > 0:
            n = -n
        add(mid + 0.35 * n, mid)
    add(np.array([-0.3, -0.2, 0.0]), a)                   # beyond each vertex
    add(np.array([1.4, -0.3, 0.0]), b)
    add(np.array([0.15, 1.2, 0.0]), c)
    return (np.asarray(pts, np.float32), np.asarray(exact),
            np.stack([a, b, c]).astype(np.float32))


def test_point_tri_sq_dists_every_region():
    p, exact, tri = voronoi_points()
    # a second, rotated triangle beside the first
    rot = np.linalg.qr(np.random.RandomState(1).normal(size=(3, 3)))[0]
    tri2 = (tri @ rot.T + [0.1, 0.2, -0.3]).astype(np.float32)
    a, b, c = (np.stack([tri[i], tri2[i]]) for i in range(3))
    t = torch.from_numpy
    got = te.point_tri_sq_dists(t(p), t(a), t(b), t(c)).numpy()
    np.testing.assert_allclose(got[:, 0], exact, rtol=0, atol=1e-6)
    ref = np.asarray(je.point_tri_sq_dists(*map(jnp.asarray, (p, a, b, c))))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_point_tri_sq_dists_grad_matches_jax():
    p, _, tri = voronoi_points()
    a, b, c = tri[None, 0], tri[None, 1], tri[None, 2]
    pt = torch.from_numpy(p).requires_grad_(True)
    d = te.point_tri_sq_dists(pt, *map(torch.from_numpy, (a, b, c)))
    (g,) = torch.autograd.grad(d.sum(), pt)
    jg = jax.grad(lambda q: jnp.sum(je.point_tri_sq_dists(
        q, *map(jnp.asarray, (a, b, c)))))(jnp.asarray(p))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_point_face_distance_chunked():
    verts, faces = sphere_mesh()
    pts = np.random.RandomState(2).uniform(-0.9, 0.9, (700, 3)).astype(np.float32)
    # max_pairs gives chunks of 20,000 // F points: several chunks
    max_pairs = 20_000
    assert max_pairs // len(faces) < len(pts)
    got = te.point_face_distance(pts, verts, faces, max_pairs=max_pairs,
                                 device="cpu")
    ref = je.point_face_distance(pts, verts, faces, max_pairs=max_pairs)
    assert got > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    whole = te.point_face_distance(pts, verts, faces, device="cpu")
    np.testing.assert_allclose(whole, got, rtol=1e-6)
    # points within ~1e-3 of the mesh, where the squared distances are ~1e-6
    # and the candidates' placement matters most
    near = je.sample_points_from_mesh(verts, faces, 500, seed=1)[0]
    near = near + 1e-3 * np.random.RandomState(3).normal(size=near.shape)
    near = near.astype(np.float32)
    got = te.point_face_distance(near, verts, faces, device="cpu")
    assert 1e-7 < got < 1e-5
    np.testing.assert_allclose(got, je.point_face_distance(near, verts, faces),
                               rtol=1e-5)


@pytest.mark.parametrize("gt_mesh", [False, True])
def test_evaluate_mesh_matches_jax(gt_mesh):
    pred_v, pred_f = sphere_mesh(r=18, radius=0.52, center=(0.02, 0.0, -0.01))
    gt_v, gt_f = sphere_mesh(r=22)
    rng = np.random.RandomState(4)
    gt_p = rng.normal(size=(900, 3))
    gt_n = gt_p / np.linalg.norm(gt_p, axis=-1, keepdims=True)
    gt_p = (0.5 * gt_n).astype(np.float32)
    gt_n = gt_n.astype(np.float32)
    kw = dict(gt_verts=gt_v, gt_faces=gt_f) if gt_mesh else {}
    got = te.evaluate_mesh(pred_v, pred_f, gt_p, gt_n, n_samples=1200,
                           device="cpu", **kw)
    ref = je.evaluate_mesh(pred_v, pred_f, gt_p, gt_n, n_samples=1200, **kw)
    assert sorted(got) == sorted(ref)
    assert ("point_face" if gt_mesh else "point_face_rev") in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   atol=ATOL.get(k, 0.0), err_msg=k)
