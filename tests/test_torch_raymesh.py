"""Port parity: the mesh ray-caster (isopoints_torch/ops/raymesh.py) against
the JAX package's ops/raymesh.py, on the CPU (the plain version).

- A random mesh cast with JAX's and the port's blocking at a ray block and
  a face chunk that split the inputs raggedly (faces padded to a chunk
  multiple): hit masks and face indices equal, t within rtol 1e-5 (XLA on
  the CPU fuses some products into fused multiply-adds, the port rounds
  each one as the kernel does; t = (e2·q)/det, and det cancels at grazing
  incidence), points within 1e-5·|t| and normals within 1e-6.
- Duplicate faces, in one chunk and across chunks: the lowest index wins
  in both packages; rays in the plane of a face (det = 0) and parallel
  above it miss it; `t_min` skips a face at the origin; the miss fills
  (t 1e10, face -1, the origin, a zero normal) are exact.
- A PyTorch model of the CUDA kernel's loop (faces one at a time in
  increasing order, a strictly smaller t replaces the best, the early cut
  on u) bit for bit against the plain version at two blockings, also on
  rays aimed at edges and vertices where u + v sits on its bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.ops.raymesh import ray_mesh_intersect as j_rmi
from isopoints_torch.ops import raymesh as trm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_scene(seed=0, n_rays=1500, n_verts=200, n_faces=420):
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-1, 1, (n_verts, 3)).astype(np.float32)
    faces = rng.randint(0, n_verts, (n_faces, 3))
    orig = (np.array([[0.0, 0.0, -3.0]]) + rng.normal(0, 0.05, (n_rays, 3))
            ).astype(np.float32)
    dirs = rng.normal(0, 0.3, (n_rays, 3)).astype(np.float32)
    dirs[:, 2] = rng.uniform(0.5, 2.0, n_rays)   # not unit: t in units of |dir|
    return orig, dirs, verts, faces


def both(orig, dirs, verts, faces, **kw):
    j = j_rmi(jnp.asarray(orig), jnp.asarray(dirs), jnp.asarray(verts),
              jnp.asarray(faces), **kw)
    t = trm.ray_mesh_intersect_plain(torch.tensor(orig), torch.tensor(dirs),
                                     torch.tensor(verts), torch.tensor(faces), **kw)
    return {k: np.asarray(getattr(j, k)) for k in j._fields}, \
        {k: getattr(t, k).numpy() for k in t._fields}


def assert_close(j, t):
    np.testing.assert_array_equal(j["hit"], t["hit"])
    np.testing.assert_array_equal(j["face_idx"], t["face_idx"])
    assert t["face_idx"].dtype == np.int32
    h = t["hit"]
    np.testing.assert_allclose(t["t"][h], j["t"][h], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(t["t"][~h], 1e10)
    err = np.abs(t["points"] - j["points"]).max(-1)
    assert np.all(err <= 1e-5 * np.maximum(np.abs(t["t"]) * (t["t"] < 1e9), 1.0))
    np.testing.assert_allclose(t["normals"], j["normals"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("ray_block,face_chunk", [(256, 128), (1024, 4096), (97, 53)],
                         ids=["ragged", "default", "odd"])
def test_random_mesh_matches_jax(ray_block, face_chunk):
    orig, dirs, verts, faces = random_scene()
    j, t = both(orig, dirs, verts, faces, ray_block=ray_block, face_chunk=face_chunk)
    assert 0.3 < t["hit"].mean() < 0.95
    assert_close(j, t)
    # normals face the ray origin
    h = t["hit"]
    assert np.all(np.sum(t["normals"][h] * dirs[h], -1) <= 0)
    np.testing.assert_allclose(np.linalg.norm(t["normals"][h], axis=-1), 1, atol=1e-6)


@pytest.mark.parametrize("face_chunk", [4096, 7], ids=["one chunk", "across chunks"])
def test_duplicate_faces_lowest_index_wins(face_chunk):
    orig, dirs, verts, faces = random_scene(seed=1, n_faces=40)
    rng = np.random.RandomState(2)
    dup = faces[rng.permutation(40)[:20]]
    all_faces = np.concatenate([faces, dup, faces[::-1]])
    j, t = both(orig, dirs, verts, all_faces, face_chunk=face_chunk)
    assert_close(j, t)
    # every hit face is the first occurrence of its triangle
    h = t["hit"]
    first = {}
    for i, f in enumerate(map(tuple, all_faces)):
        first.setdefault(f, i)
    hit_faces = t["face_idx"][h]
    assert len(hit_faces) > 100
    assert all(first[tuple(all_faces[f])] == f for f in hit_faces)


def test_parallel_rays_tmin_and_miss_fills():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],          # plane z = 0
                      [0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)   # plane z = 1
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    orig = np.array([[0.2, 0.2, -1.0],    # hits z = 0 at t 1 (dir (0, 0, 1))
                     [-1.0, 0.2, 0.0],    # in the plane z = 0: det 0, then misses z = 1
                     [-1.0, 0.2, 0.5],    # parallel between the planes
                     [0.2, 0.2, 0.0],     # on face 0: t = 0 < t_min, hits face 1
                     [0.2, 0.2, 0.5],     # t_min 0.6 skips face 1 at t 0.5
                     [5.0, 5.0, -1.0]],   # misses both
                    np.float32)
    dirs = np.array([[0, 0, 1], [1, 0, 0], [1, 0, 0], [0, 0, 1], [0, 0, 1],
                     [0, 0, 1]], np.float32)
    j, t = both(orig, dirs, verts, faces)
    assert_close(j, t)
    np.testing.assert_array_equal(t["hit"], [True, False, False, True, True, False])
    np.testing.assert_array_equal(t["face_idx"], [0, -1, -1, 1, 1, -1])
    np.testing.assert_array_equal(t["t"], np.float32([1.0, 1e10, 1e10, 1.0, 0.5, 1e10]))
    miss = ~t["hit"]
    np.testing.assert_array_equal(t["points"][miss], orig[miss])
    np.testing.assert_array_equal(t["normals"][miss], 0.0)
    np.testing.assert_array_equal(t["normals"][0], [0, 0, -1])
    j2, t2 = both(orig[4:5], dirs[4:5], verts, faces, t_min=0.6)
    assert_close(j2, t2)
    assert not t2["hit"][0]


def kernel_model(orig, dirs, packed, t_min=1e-4):
    """The CUDA kernel's loop in PyTorch: every ray against faces one at a
    time in increasing order, the early cut on u, a strictly smaller t
    replacing the best."""
    n = orig.shape[0]
    best_t = torch.full((n,), 1e10)
    best_f = torch.full((n,), -1, dtype=torch.int32)
    tm = float(np.float32(t_min))
    ox, oy, oz = orig.unbind(-1)
    dx, dy, dz = dirs.unbind(-1)
    for j, row in enumerate(packed):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = row.tolist()
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = map(
            f32, (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z))
        px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
        det = (e1x * px + e1y * py) + e1z * pz
        ok_det = det.abs() > trm._EPS_DET
        inv = torch.where(ok_det, 1.0 / det, 0.0)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = ((tx * px + ty * py) + tz * pz) * inv
        go = ok_det & (u >= trm._NEG_EPS) & ~(u > trm._U_CUT)
        qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
        v = ((dx * qx + dy * qy) + dz * qz) * inv
        t = ((e2x * qx + e2y * qy) + e2z * qz) * inv
        ok = go & (v >= trm._NEG_EPS) & (u + v <= trm._ONE_EPS) & (t > tm)
        take = ok & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_f = torch.where(take, j, best_f)
    return best_t, best_f


def test_kernel_model_equals_plain():
    orig, dirs, verts, faces = random_scene(seed=3, n_rays=600, n_faces=150)
    # add rays aimed at vertices and edge midpoints: u + v on its bound
    rng = np.random.RandomState(4)
    tri = verts[faces[rng.randint(0, 150, 200)]]
    w = np.where(rng.uniform(size=(200, 1)) < 0.5, 0.0, 0.5)
    targets = np.where(rng.uniform(size=(200, 1)) < 0.5, tri[:, 0], w * tri[:, 1]
                       + (1 - w) * tri[:, 2]).astype(np.float32)
    o2 = np.tile(np.float32([[0.1, -0.2, -3.0]]), (200, 1))
    orig = np.concatenate([orig, o2])
    dirs = np.concatenate([dirs, targets - o2]).astype(np.float32)
    o, d = torch.tensor(orig), torch.tensor(dirs)
    packed = trm.pack_faces(torch.tensor(verts), torch.tensor(faces).long())
    mt, mf = kernel_model(o, d, packed)
    for rb, fc in ((1024, 4096), (64, 16)):
        pt, pf = trm.intersect_plain(o, d, packed, ray_block=rb, face_chunk=fc)
        assert torch.equal(pt, mt) and torch.equal(pf, mf)
    assert int((mf >= 0).sum()) > 400


def test_empty_inputs():
    verts = torch.zeros((3, 3))
    faces = torch.zeros((0, 3), dtype=torch.long)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    r = trm.ray_mesh_intersect(o, d, verts, faces)
    assert not r.hit.any() and (r.face_idx == -1).all() and (r.t == 1e10).all()
    r = trm.ray_mesh_intersect(o[:0], d[:0], verts, torch.tensor([[0, 1, 2]]))
    assert r.t.shape == (0,)
