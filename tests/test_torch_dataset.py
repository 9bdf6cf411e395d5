"""The port's datasets and data writers (isopoints_torch/data/) against the
JAX package's (isopoints_tpu/data/).

- `sphere_sdf`, `torus_sdf`, `box_sdf`: within 1e-6 of JAX's.
- `export_mvr_dataset`: the port's and JAX's writers of the same arrays
  give directories that both packages' `MVRDataset`s read identically:
  items, camera matrices, intrinsics, GT points and cameras equal.
- `DTUDataset` on JAX's `make_synthetic_dtu` directory, with and without
  a `scale_mat`: intrinsics, extrinsics and cameras within 1e-6 (the RQ
  decomposition is the same numpy code), `get_scale_mat`, items and the
  GT cloud equal.
- The port's `make_synthetic_dtu` and the torus `make_synthetic_mvr`
  against JAX's under the bars of test_synthetic_dataset_matches_jax
  (tests/test_torch_e2e.py): masks equal on 99.5% of pixels, colours
  within 1e-4 where the masks agree; written images are 8-bit, so there
  colours within 1/255 + 1e-6 (one truncation step); GT points on the
  surface and their counts within 0.1%.
- A warm-up step and the resample + projected step after it, on views
  and per-view DTU cameras read from a DTU directory, forced from JAX's
  state on JAX's draws (as test_projected_steps_match_jax_from_its_state):
  iso-point counts equal, loss terms within rtol 1e-4 + atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.config import default_config_path, load_config as j_load
from isopoints_tpu.data import dataset as jds
from isopoints_tpu.data import synthetic as jsyn
from isopoints_tpu.factories import create_model as j_create_model
from isopoints_tpu.factories import create_trainer as j_create_trainer
from isopoints_tpu.rng import KeyChain
from isopoints_torch.config import load_config
from isopoints_torch.convert import params_from_jax
from isopoints_torch.data import dataset as tds
from isopoints_torch.data import synthetic as tsyn
from isopoints_torch.factories import create_model, create_trainer
from test_torch_e2e import LOSS_KEYS, _projected_draws, _step_draws


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE_MAT = np.array([[2.5, 0.0, 0.0, 0.3], [0.0, 2.5, 0.0, -0.2],
                      [0.0, 0.0, 2.5, 1.1], [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.mark.parametrize("name", ["sphere", "torus", "box"])
def test_sdfs_match_jax(name):
    x = np.random.RandomState(0).uniform(-1, 1, (4096, 3)).astype(np.float32)
    x[:8] = 0.0                       # the centre and the box's inside
    ref = np.asarray({"sphere": jsyn.sphere_sdf, "torus": jsyn.torus_sdf,
                      "box": jsyn.box_sdf}[name]()(jnp.asarray(x)))
    out = tsyn.SDFS[name]()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_cameras(tcam, jcam, atol=0.0):
    for k in ("R", "T", "focal_length", "principal_point"):
        np.testing.assert_allclose(getattr(tcam, k).numpy(),
                                   np.asarray(getattr(jcam, k)), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def mvr_dirs(tmp_path_factory):
    data = tsyn.make_synthetic_mvr(tsyn.torus_sdf(), n_views=5, image_size=24,
                                   device="cpu")
    rng = np.random.RandomState(1)
    data["img.depth"] = rng.uniform(1, 3, (5, 24, 24, 1)).astype(np.float32)
    root = tmp_path_factory.mktemp("mvr")
    tsyn.export_mvr_dataset(data, str(root / "port"))
    jsyn.export_mvr_dataset(data, str(root / "jax"))
    return data, str(root / "port"), str(root / "jax")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mvr_dataset_matches_jax(mvr_dirs, writer):
    data, port_dir, jax_dir = mvr_dirs
    d = port_dir if writer == "port" else jax_dir
    t, j = tds.MVRDataset(d), jds.MVRDataset(d)
    assert len(t) == len(j) == 5 and t.image_files == j.image_files
    for k in ("camera_mat", "focal_length", "principal_point", "points",
              "normals"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    np.testing.assert_array_equal(t.camera_mat, data["camera_mat"])
    np.testing.assert_array_equal(t.get_pointclouds()[0], data["points"])
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i])
        # the 8-bit truncation of the in-memory arrays, bit for bit
        u8 = np.clip(data["img.rgb"][i] * 255.0, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(t[i]["img.rgb"], u8.astype(np.float32) / 255.0)
        np.testing.assert_array_equal(t[i]["img.mask"], data["img.mask"][i])
    _assert_cameras(t.camera([3, 0], device="cpu"), j.camera([3, 0]))
    _assert_items_equal(tds.batch_items([t[0], t[2]]), jds.batch_items([j[0], j[2]]))
    # the port's directory and JAX's hold the same pixels
    other = tds.MVRDataset(jax_dir if writer == "port" else port_dir)
    for i in range(len(t)):
        _assert_items_equal(t[i], other[i])


def test_mvr_dense_depth(mvr_dirs, tmp_path):
    data, port_dir, _ = mvr_dirs
    t = tds.MVRDataset(port_dir, load_dense_depth=True)
    j = jds.MVRDataset(port_dir, load_dense_depth=True)
    for i in (0, 4):
        np.testing.assert_array_equal(t[i]["img.depth"], data["img.depth"][i])
        _assert_items_equal(t[i], j[i])
    exr = tmp_path / "exr"
    os.makedirs(exr / "depth")
    for sub in ("image", "mask"):
        os.symlink(os.path.join(port_dir, sub), exr / sub)
    os.symlink(os.path.join(port_dir, "data_dict.npz"), exr / "data_dict.npz")
    open(exr / "depth" / "00000.exr", "wb").close()
    with pytest.raises(ValueError, match="OpenEXR"):
        tds.MVRDataset(str(exr), load_dense_depth=True)[0]


@pytest.fixture(scope="module")
def jax_dtu_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    jsyn.make_synthetic_dtu(jsyn.torus_sdf(), str(root / "plain"), n_views=3,
                            image_size=32)
    jsyn.make_synthetic_dtu(jsyn.torus_sdf(), str(root / "scaled"), n_views=3,
                            image_size=32, scale_mat=SCALE_MAT)
    return {"plain": str(root / "plain"), "scaled": str(root / "scaled")}


@pytest.mark.parametrize("which", ["plain", "scaled"])
def test_dtu_dataset_matches_jax(jax_dtu_dirs, which):
    d = jax_dtu_dirs[which]
    t, j = tds.DTUDataset(d), jds.DTUDataset(d)
    assert len(t) == len(j) == 3
    for (tK, (tR, tt)), (jK, (jR, jt)) in zip(zip(t.intrinsics, t.extrinsics),
                                              zip(j.intrinsics, j.extrinsics)):
        for a, b in ((tK, jK), (tR, jR), (tt, jt)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t.get_scale_mat(), j.get_scale_mat())
    want = SCALE_MAT if which == "scaled" else np.eye(4, dtype=np.float32)
    np.testing.assert_array_equal(t.get_scale_mat(), want)
    _assert_cameras(t.camera([2, 1], (32, 32), device="cpu"),
                    j.camera([2, 1], (32, 32)), atol=1e-6)
    assert bool((t.camera([0], (32, 32)).focal_length < 0).all())
    for i in range(len(t)):
        _assert_items_equal(t[i], j[i])
    _assert_items_equal(t.get_gt_pointcloud(), j.get_gt_pointcloud())


def _compare_views(t_rgb, t_mask, j_rgb, j_mask, rgb_atol):
    same = t_mask == j_mask
    assert same.mean() >= 0.995
    assert j_mask.mean() > 0.02
    np.testing.assert_allclose(t_rgb[same[..., 0]], j_rgb[same[..., 0]],
                               atol=rgb_atol, rtol=0)


def test_torus_mvr_matches_jax():
    ref = jsyn.make_synthetic_mvr(jsyn.torus_sdf(), n_views=3, image_size=16)
    out = tsyn.make_synthetic_mvr(tsyn.torus_sdf(), n_views=3, image_size=16,
                                  device="cpu")
    np.testing.assert_allclose(out["camera_mat"], ref["camera_mat"], atol=1e-5)
    _compare_views(out["img.rgb"], out["img.mask"], ref["img.rgb"],
                   ref["img.mask"], 1e-4)
    assert abs(len(out["points"]) - len(ref["points"])) <= 0.001 * len(ref["points"])
    f = tsyn.torus_sdf()(torch.from_numpy(out["points"]))
    assert float(f.abs().max()) <= 1e-5


@pytest.mark.parametrize("which", ["plain", "scaled"])
def test_make_synthetic_dtu_matches_jax(jax_dtu_dirs, tmp_path, which):
    out_dir = str(tmp_path / "port")
    tsyn.make_synthetic_dtu(tsyn.torus_sdf(), out_dir, n_views=3, image_size=32,
                            scale_mat=SCALE_MAT if which == "scaled" else None,
                            device="cpu")
    ref_dir = jax_dtu_dirs[which]
    t_cams, j_cams = (np.load(os.path.join(d, "cameras.npz"))
                      for d in (out_dir, ref_dir))
    assert sorted(t_cams.files) == sorted(j_cams.files)
    for k in j_cams.files:
        np.testing.assert_allclose(t_cams[k], j_cams[k], atol=1e-5, rtol=1e-6)
    t, j = tds.DTUDataset(out_dir), jds.DTUDataset(ref_dir)
    items = lambda ds, k: np.stack([ds[i][k] for i in range(len(ds))])
    # 8-bit files: colours within one truncation step where masks agree
    _compare_views(items(t, "img.rgb"), items(t, "img.mask"),
                   items(j, "img.rgb"), items(j, "img.mask"), 1.0 / 255 + 1e-6)
    tp, jp = t.get_gt_pointcloud()["points"], j.get_gt_pointcloud()["points"]
    assert abs(len(tp) - len(jp)) <= 0.001 * len(jp)
    # the GT cloud in world coordinates: back through the similarity
    s = t.get_scale_mat()
    pts_n = (tp - s[:3, 3]) @ np.linalg.inv(s[:3, :3]).T
    f = tsyn.torus_sdf()(torch.from_numpy(pts_n.astype(np.float32)))
    assert float(f.abs().max()) <= 1e-5


def test_dtu_steps_match_jax_from_its_state(jax_dtu_dirs):
    """configs/synthetic_sphere_iso.yml with warm_up_iters 1 on the views
    and per-view cameras of JAX's DTU directory (the torus at 32 px, raster
    and visibility images cut to match): the warm-up step at it 0 from the
    same parameters, and the projected step at it 2 started from JAX's
    state after its resample step at it 1 (parameters, iso-point buffer,
    spacing). The resample itself sees no camera; its Newton stop turns a
    last-bit difference of the field into a point more or less (171 vs 170
    iso-points here), so the port's resample is not compared."""
    seed, warm = 0, 1
    cfg_path = os.path.join(ROOT, "configs", "synthetic_sphere_iso.yml")
    jcfg = j_load(cfg_path, default_config_path())
    tcfg = load_config(cfg_path, default_config_path())
    for c in (jcfg, tcfg):
        c.training.warm_up_iters = warm
        c.renderer.raster_params.image_size = 32
        c.model.combined_kwargs.visibility_image_size = 32
    d = jax_dtu_dirs["plain"]
    j_ds, t_ds = jds.DTUDataset(d), tds.DTUDataset(d)
    images = np.stack([t_ds[i]["img.rgb"] for i in range(len(t_ds))])
    masks = np.stack([t_ds[i]["img.mask"] for i in range(len(t_ds))])
    s = images.shape[1]
    j_trainer = j_create_trainer(j_create_model(jcfg), jcfg, seed=seed)
    j_state = j_trainer.init_state()
    model = create_model(tcfg, device="cpu")
    to_port = lambda params: params_from_jax(
        {"decoder": jax.tree.map(np.asarray, params["decoder"])})
    model.load_state_dict(to_port(j_state.params))
    trainer = create_trainer(model, tcfg, seed=seed, device="cpu")
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    t_state = trainer.init_state()
    keys = KeyChain(seed)
    keys.next(), keys.next()                       # init_state's two keys
    n_rays = trainer.scheduler.at(0)["n_rays"]
    m = model.ccfg.max_iso_per_batch
    rows = []
    for it in range(3):
        idx = np.random.RandomState(it).choice(len(t_ds), size=2, replace=False)
        jcam, tcam = j_ds.camera(idx, (s, s)), t_ds.camera(idx, (s, s), device="cpu")
        img, mask = images[idx], masks[idx]
        if it == warm:                 # JAX's resample step: keys only
            keys.next(), keys.next()
            j_state, _ = j_trainer.train_step(j_state, jnp.asarray(img),
                                              jnp.asarray(mask), jcam)
            continue
        if it < warm:
            draws = _step_draws(keys.next(), n_rays, trainer.cfg.n_eikonal_points,
                                model.raytrace_cfg.n_steps, (s, s))
        else:
            model.load_state_dict(to_port(j_state.params))
            t_state = t_state._replace(points=t(j_state.points),
                                       points_mask=t(j_state.points_mask),
                                       spacing=t(j_state.spacing), it=it)
            draws = _projected_draws(keys.next(), n_rays,
                                     trainer.cfg.n_eikonal_points,
                                     model.raytrace_cfg.n_steps, (s, s),
                                     t_state.points.shape[1], m)
        j_state, jm = j_trainer.train_step(j_state, jnp.asarray(img),
                                           jnp.asarray(mask), jcam)
        t_state, tm = trainer.train_step(t_state, torch.from_numpy(img),
                                         torch.from_numpy(mask), tcam,
                                         draws=draws)
        rows.append((it, jm, tm))
    for it, jm, tm in rows:
        assert tm["n_iso"] == jm["n_iso"] > 0, it
        for k in LOSS_KEYS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"it {it} {k}")
