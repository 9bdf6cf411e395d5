"""Port parity: the ablation's scripts (isopoints_torch/summarize_ablation.py,
evaluate_pointclouds.py, filter_dtu_predictions.py) against the JAX
package's scripts/, on the CPU.

- `summarize_ablation` on synthetic metrics.jsonl files of three arms (one
  resumed, one without evaluation rows), with `--no-finals`, with and
  without `--truncate-at`: the table, the curves and the printed lines
  equal the JAX script's; the raw metrics are copied beside `--out`, and
  the default `--out` lies beside the first arm's directory.
- Its finals on converted parameters of a small SIREN (12³ meshes): the
  same arms scored, chamfer_p within rtol 1e-3 (grids of the two packages'
  SIREN values differ in the last bits, which move the marching-tetrahedra
  vertices; the samples are the same seeded draws), and the `--truncate-at`
  skip.
- `evaluate_pointclouds` with the seeded subsample: every metric within
  rtol 1e-5 (float32 means).
- `filter_dtu_predictions` on a 4-view DTU torus with points on the
  surface, around it and outside every silhouette: the kept set equal.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from isopoints_tpu.utils.io import read_ply as j_read_ply
from isopoints_torch import evaluate_pointclouds, filter_dtu_predictions, get_logger
from isopoints_torch import summarize_ablation as ts
from isopoints_torch.config import default_config_path, load_config, save_config
from isopoints_torch.utils.io import read_ply, save_ply

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import evaluate_pointclouds as j_eval_pc  # noqa: E402
import filter_dtu_predictions as j_filter  # noqa: E402
import summarize_ablation as js  # noqa: E402

# the port's logger binds its handler to the stream of its first call: make
# that call here, not under a test's capsys, whose stream closes with it
get_logger()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_metrics(d, rows):
    import json
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def synthetic_arms(root, seed=0):
    """Three arms' metrics: 'implicit' plain, 'uni' resumed once (its
    iterations go back), 'lossS' with training rows only."""
    rng = np.random.RandomState(seed)
    dirs = []
    for name, resume, evals in (("implicit", False, True), ("uni", True, True),
                                ("lossS", False, False)):
        rows, ts_ = [], 1000.0 + rng.uniform(0, 10)
        its = list(range(0, 30))
        if resume:
            its = its[:17] + list(range(12, 30))
        for it in its:
            ts_ += rng.uniform(0.05, 0.2)
            rows.append({"it": it, "ts": ts_, "loss": float(rng.uniform())})
            if evals and it > 0 and it % 5 == 0:
                ts_ += rng.uniform(1, 2)
                rows.append({"it": it, "ts": ts_,
                             "eval_psnr_full": float(rng.uniform(10, 30)),
                             "eval_iou_full": float(rng.uniform(0.3, 0.9)),
                             "eval_chamfer": float(rng.uniform(1e-4, 1e-2))})
        d = os.path.join(root, f"ablation_{name}")
        write_metrics(d, rows)
        dirs.append(d)
    return dirs


def run_jax(monkeypatch, tmp_path, argv):
    """scripts/summarize_ablation.py's main in tmp_path (it copies the raw
    metrics into ./ablation_metrics); returns its lines."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["summarize_ablation.py"] + argv)
    js.main()
    out = argv[argv.index("--out") + 1]
    with open(out) as f:
        return f.read().split("\n")


def table_and_curves(lines):
    head = lines.index("| arm | iters reached | med ms/step | final PSNR | final IoU "
                       "| final chamfer | best PSNR | best IoU | best chamfer |")
    # up to the line naming where the raw metrics were copied
    end = next(i for i, line in enumerate(lines) if line.startswith("Raw per-arm"))
    return lines[head:end]


@pytest.mark.parametrize("truncate", [0, 6], ids=["whole run", "truncated"])
def test_summarize_table_matches_jax(monkeypatch, tmp_path, capsys, truncate):
    dirs = synthetic_arms(str(tmp_path / "arms"))
    common = ["--no-finals", "--budget", "60", "--truncate-at", str(truncate)]
    j = run_jax(monkeypatch, tmp_path, dirs + common + ["--out", str(tmp_path / "j.md")])
    j_printed = capsys.readouterr().out.split("\n")[1:]
    res = ts.main(dirs + common + ["--out", str(tmp_path / "t" / "t.md"), "--device", "cpu"])
    t_printed = capsys.readouterr().out.split("\n")[1:]
    assert table_and_curves(res["lines"]) == table_and_curves(j)
    assert t_printed[3:] == j_printed[3:]   # the table's header and rows
    assert [name for name, r in res["rows"] if r is None] == ["lossS"]
    for name in ("implicit", "uni", "lossS"):
        assert os.path.exists(tmp_path / "t" / "ablation_metrics" / f"{name}.jsonl")
    # the resumed arm is reported as such in both
    assert any("uni x1" in line for line in res["lines"])
    assert any("uni x1" in line for line in j)


def test_summarize_default_out(tmp_path, capsys):
    dirs = synthetic_arms(str(tmp_path / "runs"))
    res = ts.main(dirs + ["--no-finals", "--device", "cpu"])
    assert res["out"] == str(tmp_path / "runs" / "ABLATION.md")
    assert os.path.exists(res["out"])
    assert os.path.exists(tmp_path / "runs" / "ablation_metrics" / "uni.jsonl")


SMALL_CFG = """
model:
  type: implicit
  decoder_type: siren
  decoder_kwargs:
    hidden_size: 32
    n_layers: 1
"""


def make_checkpoints(tmp_path, dirs_j, dirs_t):
    """The same random SIREN per arm as a JAX model.npz and a port one."""
    from isopoints_tpu.config import load_config as j_load_config
    from isopoints_tpu.factories import create_model as j_create_model
    from isopoints_tpu.misc.checkpoints import CheckpointIO as JCk
    from isopoints_torch.convert import params_from_jax
    from isopoints_torch.factories import create_model
    from isopoints_torch.misc.checkpoints import CheckpointIO

    src = tmp_path / "small.yml"
    src.write_text(SMALL_CFG)
    cfg = load_config(str(src), default_config_path())
    for i, (dj, dt) in enumerate(zip(dirs_j, dirs_t)):
        for d in (dj, dt):
            save_config(os.path.join(d, "config.yaml"), cfg)
        jm = j_create_model(j_load_config(os.path.join(dj, "config.yaml")))
        params = jm.init(jax.random.key(11 + i))
        JCk(dj, model=params).save("model.npz")
        model = create_model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        CheckpointIO(dt, model=model.state_dict()).save("model.npz")


def test_summarize_finals_match_jax(monkeypatch, tmp_path, capsys):
    dirs_j = synthetic_arms(str(tmp_path / "jax"))
    dirs_t = synthetic_arms(str(tmp_path / "torch"))
    make_checkpoints(tmp_path, dirs_j, dirs_t)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(5)
    gt = rng.normal(size=(500, 3))
    gt = (0.4 * gt / np.linalg.norm(gt, axis=-1, keepdims=True)).astype(np.float32)
    np.savez(data / "data_dict.npz", points=gt)
    common = ["--final-mesh-resolution", "12", "--data-dir", str(data)]
    j = run_jax(monkeypatch, tmp_path, dirs_j + common + ["--out", str(tmp_path / "j.md")])
    res = ts.main(dirs_t + common + ["--out", str(tmp_path / "t.md"), "--device", "cpu"])
    capsys.readouterr()
    j_finals = {line.split("|")[1].strip(): float(line.split("|")[2])
                for line in j if line.startswith("| ") and line.count("|") == 3
                and "chamfer_p" not in line}
    assert set(res["finals"]) == set(j_finals) == {"implicit", "uni", "lossS"}
    for name, v in res["finals"].items():
        assert np.isfinite(v)
        np.testing.assert_allclose(v, j_finals[name], rtol=1e-3)
        assert set(res["final_times"][name]) >= {"mesh", "largest", "evaluate"}
    # an arm whose run outlasts T is skipped, in both
    res = ts.main(dirs_t + common + ["--out", str(tmp_path / "t2.md"), "--device", "cpu",
                                     "--truncate-at", "3"])
    capsys.readouterr()
    assert res["skipped"] == ["implicit", "uni", "lossS"] and not res["finals"]


def test_evaluate_pointclouds_matches_jax(monkeypatch, tmp_path, capsys):
    rng = np.random.RandomState(1)
    a = rng.normal(size=(800, 3)).astype(np.float32)
    b = (rng.normal(size=(700, 3)) * 0.9).astype(np.float32)
    na = rng.normal(size=(800, 3)).astype(np.float32)
    nb = rng.normal(size=(700, 3)).astype(np.float32)
    pa, pb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    save_ply(pa, a, normals=na)
    save_ply(pb, b, normals=nb)
    monkeypatch.setattr(sys, "argv", ["evaluate_pointclouds.py", pa, pb,
                                      "--max-points", "600"])
    j_eval_pc.main()
    j = dict(line.split(": ") for line in capsys.readouterr().out.strip().split("\n"))
    t = evaluate_pointclouds.main([pa, pb, "--max-points", "600", "--device", "cpu"])
    capsys.readouterr()
    assert set(t) == set(j) == {"chamfer_p", "chamfer_n"}
    for k in t:
        np.testing.assert_allclose(t[k], float(j[k]), rtol=1e-5)


def test_filter_dtu_predictions_matches_jax(monkeypatch, tmp_path):
    from isopoints_torch.data.synthetic import make_synthetic_dtu, torus_sdf
    dtu = str(tmp_path / "dtu")
    make_synthetic_dtu(torus_sdf(), dtu, n_views=4, image_size=32, device="cpu")
    rng = np.random.RandomState(2)
    surf = read_ply(os.path.join(dtu, "points.ply"))["points"][:1500]
    near = surf + rng.normal(0, 0.03, surf.shape).astype(np.float32)
    far = rng.uniform(-1, 1, (500, 3)).astype(np.float32) * [1, 1, 0.2] + [0, 0, 0.8]
    pts = np.concatenate([surf, near, far]).astype(np.float32)
    scan = str(tmp_path / "scan.ply")
    save_ply(scan, pts, normals=rng.normal(size=pts.shape).astype(np.float32))
    jout, tout = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    monkeypatch.setattr(sys, "argv", ["filter_dtu_predictions.py", scan, dtu, jout,
                                      "--chunk", "700"])
    j_filter.main()
    keep = filter_dtu_predictions.main([scan, dtu, tout, "--chunk", "700",
                                        "--device", "cpu"])
    jp = j_read_ply(jout)
    tp = read_ply(tout)
    np.testing.assert_array_equal(tp["points"], jp["points"])
    np.testing.assert_array_equal(tp["normals"], jp["normals"])
    # at 32 px the nearest mask pixel misses part of the silhouette's rim
    assert keep[:1500].mean() > 0.6 and 0 < keep.sum() < len(pts)
    # at least two views vote: a looser rule keeps at least as many
    keep2 = filter_dtu_predictions.main([scan, dtu, tout, "--min-views", "2",
                                         "--device", "cpu"])
    assert np.all(keep2 >= keep)
