"""Port parity: mesh-rendered MVR data (isopoints_torch/data/synthetic.py
`make_mesh_mvr`, `python -m isopoints_torch.create_mvr_data mesh` and
`python -m isopoints_torch.make_ablation_data`) against the JAX package's
data/synthetic.py and scripts/make_ablation_data.py, on the CPU, at 4 views
x 32 px.

- `normalize_mesh` bit for bit; the compound SDF within 1e-6 on random
  points; its mesh at 32³ after `largest_component` with the same faces and
  vertices bit for bit (one grid, the same marching tetrahedra).
- `make_mesh_mvr`: masks, faces, GT samples and normals bit for bit (the
  same seeded host draws on the same vertices), cameras within 2e-7 (the
  look-at products rounded in another order), rgb within 1e-6 (flat shading
  of the same normals), depth within rtol 1e-5 (the ray caster's t, see
  test_torch_raymesh.py).
- The two entries write the MVR layout (image/, mask/, depth/, data_dict.npz,
  mesh.ply; mesh_source.ply for the ablation), which `MVRDataset` reads back
  equal to the arrays that were returned.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.data import synthetic as js
from isopoints_tpu.utils.io import save_ply as j_save_ply
from isopoints_tpu.utils.meshing import extract_mesh as j_extract
from isopoints_tpu.utils.meshing import largest_component as j_largest
from isopoints_torch import create_mvr_data, make_ablation_data
from isopoints_torch.data import synthetic as ts
from isopoints_torch.data.dataset import MVRDataset

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_ablation_data as j_abl  # noqa: E402  (scripts/, numpy at import)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def compound():
    """The JAX pipeline's compound mesh at 32³ and its 4-view dataset."""
    verts, faces = j_largest(*j_extract(j_abl.compound_sdf(), 32,
                                        bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3))
    verts, faces = np.asarray(verts), np.asarray(faces)
    data = js.make_mesh_mvr(verts, faces, n_views=4, image_size=32,
                            n_gt_points=500, norm_radius=0.7, seed=0)
    return verts, faces, {k: np.asarray(v) for k, v in data.items()}


def assert_data_close(j, t):
    assert set(j) == set(t)
    for k in ("img.mask", "points", "normals", "mesh_verts", "mesh_faces",
              "focal_length", "principal_point"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_allclose(t["camera_mat"], j["camera_mat"], rtol=0, atol=2e-7)
    np.testing.assert_allclose(t["img.rgb"], j["img.rgb"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["img.depth"], j["img.depth"], rtol=1e-5, atol=0)
    for k in ("img.rgb", "img.mask", "img.depth", "camera_mat"):
        assert t[k].dtype == np.float32, k


def test_normalize_mesh_and_compound_sdf():
    rng = np.random.RandomState(0)
    v = rng.uniform(-3, 5, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(ts.normalize_mesh(v, 0.7), js.normalize_mesh(v, 0.7))
    x = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        make_ablation_data.compound_sdf()(torch.tensor(x)).numpy(),
        np.asarray(j_abl.compound_sdf()(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_make_mesh_mvr_matches_jax(compound):
    verts, faces, j = compound
    t = ts.make_mesh_mvr(verts, faces, n_views=4, image_size=32, n_gt_points=500,
                         norm_radius=0.7, seed=0, device="cpu")
    assert_data_close(j, t)
    assert 0.05 < t["img.mask"].mean() < 0.9
    assert np.all(t["img.depth"][t["img.mask"] == 0] == 100.0)


def test_make_mesh_mvr_without_normalizing_matches_jax(compound):
    """`normalize=False` (synthetic.py:177, 191): the mesh is taken as it is,
    in float32; JAX's dataset on the same mesh at the file's tolerances."""
    verts, faces, _ = compound
    verts = (0.6 * verts + np.float32(0.05)).astype(np.float64)
    kw = dict(n_views=3, image_size=24, n_gt_points=300, seed=1, normalize=False)
    j = {k: np.asarray(v) for k, v in js.make_mesh_mvr(verts, faces, **kw).items()}
    t = ts.make_mesh_mvr(verts, faces, device="cpu", **kw)
    assert_data_close(j, t)
    np.testing.assert_array_equal(t["mesh_verts"], verts.astype(np.float32))
    assert t["mesh_verts"].dtype == np.float32
    assert not np.array_equal(t["mesh_verts"], ts.make_mesh_mvr(
        verts, faces, device="cpu", **dict(kw, normalize=True))["mesh_verts"])
    assert 0.02 < t["img.mask"].mean() < 0.9


def read_back(out_dir, n_views):
    ds = MVRDataset(out_dir)
    assert len(ds) == n_views
    items = [ds[i] for i in range(n_views)]
    depth = np.stack([np.load(os.path.join(out_dir, "depth", f"{i:05d}.npy"))
                      for i in range(n_views)])
    return ds, items, depth


def test_create_mvr_data_mesh(compound, tmp_path):
    verts, faces, _ = compound
    mesh = str(tmp_path / "m.ply")
    j_save_ply(mesh, verts, faces=faces)
    from isopoints_tpu.utils.io import load_mesh
    m = load_mesh(mesh)
    j = {k: np.asarray(v) for k, v in js.make_mesh_mvr(
        m["points"], m["faces"], n_views=4, image_size=32, n_gt_points=300,
        norm_radius=0.6, seed=3).items()}
    out = str(tmp_path / "data")
    t = create_mvr_data.main(["mesh", out, "--mesh", mesh, "--n-views", "4",
                              "--image-size", "32", "--n-gt-points", "300",
                              "--norm-radius", "0.6", "--seed", "3",
                              "--device", "cpu"])
    assert_data_close(j, t)
    ds, items, depth = read_back(out, 4)
    np.testing.assert_array_equal(depth, t["img.depth"])
    np.testing.assert_array_equal(np.stack([i["img.mask"] for i in items]),
                                  t["img.mask"])
    pts, nrm, _ = ds.get_pointclouds()
    np.testing.assert_array_equal(pts, t["points"])
    assert os.path.exists(os.path.join(out, "mesh.ply"))
    with pytest.raises(SystemExit):
        create_mvr_data.main(["mesh", out, "--device", "cpu"])   # no --mesh


def test_make_ablation_data_matches_jax(compound, tmp_path):
    verts, faces, j = compound
    out = str(tmp_path / "abl")
    tv, tf, t = make_ablation_data.main([out, "--image-size", "32", "--n-views", "4",
                                         "--mesh-resolution", "32",
                                         "--n-gt-points", "500", "--device", "cpu"])
    np.testing.assert_array_equal(tf, faces)
    np.testing.assert_array_equal(tv, verts)
    assert_data_close(j, t)
    for f in ("data_dict.npz", "mesh.ply", "mesh_source.ply", "image/00003.png",
              "mask/00000.png", "depth/00003.npy"):
        assert os.path.exists(os.path.join(out, f)), f
    _, items, depth = read_back(out, 4)
    np.testing.assert_array_equal(depth, t["img.depth"])
    # the PNG round trip quantises to 8 bits
    rgb = np.stack([i["img.rgb"] for i in items])
    np.testing.assert_allclose(rgb, t["img.rgb"], atol=1.0 / 255)
