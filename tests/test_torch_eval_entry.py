"""The validate cadence and the generate / evaluate entries of the port
(isopoints_torch/training/trainer.py `eval_step`, `eval_step_full`,
`evaluate_mesh_vs_gt`; train_mvr.py; generate_mvr.py; evaluate.py), on the
CPU, against the JAX package where it has the same function.

- `eval_step` on the same pixel draws as JAX's (rebuilt from its key chain
  as trainer.py:468-470 splits it): the IoU equal, MSE and PSNR within rtol
  1e-4; `eval_step_full` (whole 16-px views): the IoU within 1% (a pixel
  of 512 may flip at the silhouette), MSE within rtol 2e-3; each draws one
  generator from the chain where JAX draws its key, `evaluate_mesh_vs_gt`
  none. `evaluate_mesh_vs_gt` at 24³: chamfer rtol 1e-3 (the meshes'
  vertices within 1e-5, the samples drawn on the host from the same seed);
  an empty mesh scores inf.
- `train_mvr --validate-every 2 --visualize-every 2` on a sphere directory:
  `eval_` rows at its 2 and 4, model_best.npz holding the best `iou_full`,
  the meshes written; the training rows before the first evaluation equal
  a run without it bit for bit.
- `generate_mvr` (mesh 24, 2 views of 16 px) and `evaluate` (400 samples:
  the point-face term pairs each GT sample with every face of the run's
  ~58k) on that run; `--gt-sdf sphere` with 2000 samples on an analytic
  sphere mesh (chamfer_p < 5e-3, as tests/test_entries.py bounds JAX's,
  and the port's GT samples and every metric within rtol 1e-4 of JAX's
  evaluate.py on the same directory); a DTU scan with a non-identity scale_mat: `generate_mvr`
  writes the mesh in world coordinates with its marker, `evaluate
  --scale-mat-from` leaves that mesh alone and denormalizes an unmarked one.
"""

import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.models.combined import CombinedModel as JCombined
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.implicit import ImplicitConfig as JIC
from isopoints_tpu.ops.images import sample_random_pixels as j_pixels
from isopoints_tpu.training.trainer import MVRTrainer as JTrainer
from isopoints_tpu.training.trainer import TrainerConfig as JTrainerConfig
from isopoints_tpu.training.trainer import TrainState as JState
from isopoints_torch import create_mvr_data, evaluate, generate_mvr, train_mvr
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.camera import cameras_from_matrices
from isopoints_torch.data import synthetic
from isopoints_torch.factories import create_model
from isopoints_torch.config import default_config_path, load_config
from isopoints_torch.misc.checkpoints import CheckpointIO
from isopoints_torch.misc.metrics import load_metrics
from isopoints_torch.models.combined import CombinedModel
from isopoints_torch.models.fields import SirenField
from isopoints_torch.models.generator import Generator, GeneratorConfig
from isopoints_torch.models.implicit import ImplicitConfig
from isopoints_torch.training.trainer import MVRTrainer, TrainState
from isopoints_torch.utils.io import read_ply, save_ply
from isopoints_torch.utils.meshing import extract_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    data = synthetic.make_synthetic_mvr(synthetic.sphere_sdf(), n_views=4,
                                        image_size=16, device="cpu")
    idx = np.array([0, 2])
    img, mask = data["img.rgb"][idx], data["img.mask"][idx]
    mats = data["camera_mat"][idx]
    jcam = JCam.create(R=mats[:, :3, :3], T=mats[:, 3, :3],
                       focal_length=data["focal_length"],
                       principal_point=data["principal_point"])
    tcam = cameras_from_matrices(mats, data["focal_length"],
                                 data["principal_point"], device="cpu")
    jm = JCombined(JSiren(hidden_size=64, n_layers=2), cfg=JIC())
    params = jm.init(jax.random.key(0))
    tm = CombinedModel(SirenField(hidden_size=64, n_layers=2, device="cpu"),
                       ImplicitConfig(use_fused_mlp=True,
                                      raytrace={"sampler_in_kernel": True}))
    tm.load_state_dict(params_from_jax(
        {"decoder": jax.tree.map(np.asarray, params["decoder"])}))
    jt = JTrainer(jm, JTrainerConfig(), seed=3)
    tt = MVRTrainer(tm, seed=3, device="cpu")
    return dict(data=data, img=img, mask=mask, jcam=jcam, tcam=tcam,
                params=params, jt=jt, tt=tt,
                jstate=JState(params=params, opt_state=None, points=None,
                              points_mask=None, it=0),
                tstate=TrainState(opt_state=None, points=None,
                                  points_mask=None, it=0))


def test_eval_step_same_draws(world):
    w = world
    n_rays = 512
    # JAX's draw: keys.next() split in two, the first for the pixels
    k = jax.random.split(w["jt"].keys._key, 2)[1]
    k1, _ = jax.random.split(k)
    pixels = j_pixels(k1, n_rays, (16, 16), batch_size=2)
    ref = w["jt"].eval_step(w["jstate"], jnp.asarray(w["img"]),
                            jnp.asarray(w["mask"]), w["jcam"], n_rays=n_rays)
    before = w["tt"].generators.state()
    got = w["tt"].eval_step(w["tstate"], torch.from_numpy(w["img"]),
                            torch.from_numpy(w["mask"]), w["tcam"],
                            n_rays=n_rays,
                            pixels=torch.from_numpy(np.array(pixels)))
    assert not np.array_equal(before, w["tt"].generators.state())
    assert sorted(got) == sorted(ref) == ["iou", "psnr", "rgb_mse"]
    assert 0.0 < got["iou"] < 1.0 and got["iou"] == pytest.approx(ref["iou"], abs=0)
    for k in ("rgb_mse", "psnr"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def test_eval_step_full(world):
    w = world
    ref = w["jt"].eval_step_full(w["jstate"], jnp.asarray(w["img"]),
                                 jnp.asarray(w["mask"]), w["jcam"])
    before = w["tt"].generators.state()
    got = w["tt"].eval_step_full(w["tstate"], torch.from_numpy(w["img"]),
                                 torch.from_numpy(w["mask"]), w["tcam"])
    assert not np.array_equal(before, w["tt"].generators.state())
    assert sorted(got) == sorted(ref) == ["iou_full", "mse_full", "psnr_full"]
    assert 0.0 < got["iou_full"] <= 1.0
    np.testing.assert_allclose(got["iou_full"], ref["iou_full"], atol=0.01)
    np.testing.assert_allclose(got["mse_full"], ref["mse_full"], rtol=2e-3)
    with pytest.raises(AssertionError, match="square"):
        w["tt"].eval_step_full(w["tstate"], torch.zeros(2, 16, 12, 3),
                               torch.zeros(2, 16, 12, 1), w["tcam"])


def test_evaluate_mesh_vs_gt(world):
    w = world
    # 300 of the GT samples: the point-face term pairs each with every face
    gt, gt_n = w["data"]["points"][:300], w["data"]["normals"][:300]
    before = w["tt"].generators.state()
    got = w["tt"].evaluate_mesh_vs_gt(w["tstate"], gt, gt_n, resolution=24)
    assert np.array_equal(before, w["tt"].generators.state())
    ref = w["jt"].evaluate_mesh_vs_gt(w["jstate"], gt, gt_n, resolution=24)
    assert sorted(got) == sorted(ref) == ["chamfer", "chamfer_n"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    empty = MVRTrainer(CombinedModel(SirenField(hidden_size=8, n_layers=1,
                                                device="cpu")), device="cpu")
    with torch.no_grad():
        for p in empty.model.parameters():
            p.zero_()
        empty.model.decoder.layers[-1].bias.fill_(1.0)   # sdf = 1 everywhere
    assert empty.evaluate_mesh_vs_gt(w["tstate"], gt, resolution=8) == {
        "chamfer": float("inf")}


CFG = """inherit_from: {root}/configs/synthetic_sphere_iso.yml
data:
  type: MVR
  data_dir: {data}
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_entry")
    create_mvr_data.main(["sphere", str(root / "data"), "--n-views", "4",
                          "--image-size", "24", "--device", "cpu"])
    # 300 GT samples: the validation's point-face term pairs each with every
    # face of the mesh
    path = root / "data" / "data_dict.npz"
    with np.load(path) as f:
        d = {k: f[k] for k in f.files}
    d["points"], d["normals"] = d["points"][:300], d["normals"][:300]
    np.savez(path, **d)
    cfg = root / "sphere.yml"
    cfg.write_text(CFG.format(root=ROOT, data=root / "data"))
    common = [str(cfg), "--device", "cpu", "--max-iters", "5",
              "--print-every", "100", "--checkpoint-every", "1000"]
    train_mvr.main([*common, "--out-dir", str(root / "run"),
                    "--validate-every", "2", "--visualize-every", "2",
                    "--eval-mesh-resolution", "24"])
    train_mvr.main([*common, "--out-dir", str(root / "plain")])
    return root, str(cfg)


def _rows(out):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in load_metrics(os.path.join(str(out), "metrics.jsonl"))]


def test_train_validates_and_keeps_the_best(trained):
    root, _ = trained
    rows = _rows(root / "run")
    evals = [r for r in rows if any(k.startswith("eval_") for k in r)]
    assert [r["it"] for r in evals] == [2, 4]
    keys = {"it", "eval_iou", "eval_rgb_mse", "eval_psnr", "eval_iou_full",
            "eval_psnr_full", "eval_mse_full", "eval_chamfer", "eval_chamfer_n"}
    for r in evals:
        assert set(r) == keys
        assert all(np.isfinite(r[k]) for k in keys)
        assert 0.0 <= r["eval_iou_full"] <= 1.0
    # the training rows up to the first evaluation equal a run without it
    train_rows = [r for r in rows if r not in evals]
    plain = _rows(root / "plain")
    assert train_rows[:3] == plain[:3] and len(train_rows) == len(plain) == 5
    with np.load(root / "run" / "model_best.npz") as best, \
            np.load(root / "run" / "model.npz") as last:
        assert float(best["scalar:loss_val_best"]) == max(
            r["eval_iou_full"] for r in evals)
        assert int(best["scalar:it"]) in (3, 5)
        assert sorted(best.files) == sorted(last.files + ["scalar:loss_val_best"])
    for it in (2, 4):
        mesh = read_ply(str(root / "run" / f"{it:06d}_mesh.ply"))
        assert len(mesh["faces"]) > 0


def test_generate_and_evaluate_entries(trained):
    root, cfg = trained
    out = root / "gen"
    verts, faces, rgba = generate_mvr.main([
        cfg, "--checkpoint", str(root / "run" / "model.npz"), "--out-dir",
        str(out), "--mesh-resolution", "24", "--image-size", "16",
        "--n-views", "2", "--device", "cpu"])
    assert rgba.shape == (2, 16, 16, 4) and len(faces) > 0
    assert sorted(os.listdir(out)) == ["mesh.ply", "view_000.png", "view_001.png"]
    np.testing.assert_array_equal(read_ply(str(out / "mesh.ply"))["points"], verts)
    rows = evaluate.main([str(out), "--gt-sdf", "sphere", "--n-samples", "400",
                          "--device", "cpu"])
    assert [r["mesh"] for r in rows] == ["mesh.ply"]
    with open(out / "eval.csv") as f:
        csv_rows = list(csv.DictReader(f))
    assert list(csv_rows[0]) == ["mesh", "chamfer_p", "point_face_rev"]
    assert all(np.isfinite(float(csv_rows[0][k])) for k in list(csv_rows[0])[1:])


def _jax_evaluate(argv, monkeypatch):
    """Run the JAX package's evaluate.py main on `argv`."""
    sys.path.insert(0, ROOT)
    try:
        import evaluate as j_evaluate
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
    j_evaluate.main()


def test_evaluate_gt_sdf_sphere_against_jax(tmp_path, monkeypatch):
    verts, faces = extract_mesh(synthetic.sphere_sdf(0.5), resolution=32,
                                device="cpu")
    save_ply(str(tmp_path / "final.ply"), verts, faces=faces)
    rows = evaluate.main([str(tmp_path), "--gt-sdf", "sphere", "--n-samples",
                          "2000", "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["chamfer_p"] < 5e-3, rows
    got = evaluate.analytic_gt_points("sphere", 2000, "cpu")
    from isopoints_tpu.data import synthetic as j_syn
    from isopoints_tpu.models.levelset import project_points_newton as j_newton
    init = jnp.asarray(np.random.RandomState(0).uniform(-0.8, 0.8, (1, 2000, 3)),
                       jnp.float32)
    proj = j_newton(j_syn.sphere_sdf(), init, jnp.ones((1, 2000), bool),
                    max_iters=30, tolerance=1e-5)
    ref = np.asarray(proj.points[0])[np.asarray(proj.mask[0])]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    os.remove(tmp_path / "eval.csv")
    _jax_evaluate([str(tmp_path), "--gt-sdf", "sphere", "--n-samples", "2000"],
                  monkeypatch)
    with open(tmp_path / "eval.csv") as f:
        j_row = next(csv.DictReader(f))
    assert sorted(j_row) == sorted(rows[0])
    for k in ("chamfer_p", "point_face_rev"):
        np.testing.assert_allclose(rows[0][k], float(j_row[k]), rtol=1e-4,
                                   err_msg=k)


def test_dtu_scale_mat_marker(tmp_path):
    sm = np.eye(4, dtype=np.float32)
    sm[:3, :3] *= 2.5
    sm[:3, 3] = [10.0, -4.0, 3.0]
    scan = tmp_path / "scan"
    synthetic.make_synthetic_dtu(synthetic.sphere_sdf(0.5), str(scan),
                                 n_views=2, image_size=16, scale_mat=sm,
                                 device="cpu")
    cfg_path = tmp_path / "dtu.yml"
    cfg_path.write_text(CFG.replace("MVR", "DTU").format(root=ROOT, data=scan))
    cfg = load_config(str(cfg_path), default_config_path())
    model = create_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    CheckpointIO(str(tmp_path / "run"), model=model.state_dict()).save("model.npz")
    gen_dir = tmp_path / "run" / "generation"
    verts, faces, _ = generate_mvr.main([
        str(cfg_path), "--checkpoint", str(tmp_path / "run" / "model.npz"),
        "--mesh-resolution", "24", "--image-size", "16", "--n-views", "2",
        "--device", "cpu"])
    assert os.path.exists(gen_dir / "mesh.ply.denormalized")
    nv, nf = Generator(model, GeneratorConfig(mesh_resolution=24)).generate_mesh()
    assert len(faces) > 0
    np.testing.assert_array_equal(faces, nf)
    np.testing.assert_array_equal(verts, nv @ sm[:3, :3].T + sm[:3, 3])

    # a normalized sphere mesh, marked and unmarked, against the world GT
    exp = tmp_path / "exp"
    nv, nf = extract_mesh(synthetic.sphere_sdf(0.5), resolution=24, device="cpu")
    wv = nv @ sm[:3, :3].T + sm[:3, 3]
    save_ply(str(exp / "a" / "mesh.ply"), nv, faces=nf)          # normalized
    save_ply(str(exp / "b" / "mesh.ply"), wv, faces=nf)          # world
    open(exp / "b" / "mesh.ply.denormalized", "w").close()
    gt = str(scan / "points.ply")
    rows = {r["mesh"]: r for r in evaluate.main(
        [str(exp), "--gt-points", gt, "--n-samples", "500", "--scale-mat-from",
         str(scan), "--device", "cpu"])}
    good = rows[os.path.join("a", "mesh.ply")]["chamfer_p"]
    # two independent 500-point samples of the 1.25-radius sphere lie
    # ~area/(π·500) apart squared each way: ~0.025 in all
    assert good < 0.05 and rows[os.path.join("b", "mesh.ply")]["chamfer_p"] == good
    bad = {r["mesh"]: r for r in evaluate.main(
        [str(exp), "--gt-points", gt, "--n-samples", "500", "--device", "cpu"])}
    assert bad[os.path.join("a", "mesh.ply")]["chamfer_p"] > 10 * good
