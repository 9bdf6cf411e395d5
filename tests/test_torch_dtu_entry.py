"""The DTU workload's entry (`python -m isopoints_torch.train_dtu_points`)
and its `sdf` decoder against the JAX package, on the CPU.

- `load_cloud`: the synthetic torus against train_dtu_points.load_cloud
  (the same RandomState draws; Newton on the analytic torus in both: masks
  equal, then points within 1e-5), and a `.ply` with and without normals,
  subsampled: equal.
- The IGR 8x512 `sdf` decoder (the plain field in both packages): two
  warm-up steps on replayed JAX draws from the converted JAX
  initialisation, every loss term within rtol 1e-5.
- The entry end to end with `--device cpu` at a tiny size: the iso-point
  PLYs of each refresh and final.ply (the world frame's mapping is held in
  tests/test_torch_dtu_fit.py); without
  `--device` it asks for CUDA and raises where there is none.
"""

import os

import numpy as np
import pytest
import torch

import train_dtu_points as j_entry
from isopoints_tpu.workloads import dtu_points as jw
from isopoints_torch import train_dtu_points as entry
from isopoints_torch.utils.io import read_ply, save_ply
from isopoints_torch.workloads import dtu_points as tw
from test_torch_dtu_fit import assert_terms, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_load_cloud_synthetic_matches_jax():
    pts, nrm = entry.load_cloud("synthetic:torus", 0.02, 3000, 4, device="cpu")
    jpts, jnrm = j_entry.load_cloud("synthetic:torus", 0.02, 3000, 4)
    assert nrm is None and jnrm is None
    assert pts.dtype == np.float32 and pts.shape == jpts.shape
    assert len(pts) > 2500
    np.testing.assert_allclose(pts, jpts, rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_normals", [True, False])
def test_load_cloud_ply_matches_jax(with_normals, tmp_path):
    rng = np.random.RandomState(2)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32) if with_normals else None
    path = str(tmp_path / "scan.ply")
    save_ply(path, pts, normals=nrm)
    for n in (0, 200):
        got = entry.load_cloud(path, 0.0, n, 3, device="cpu")
        ref = j_entry.load_cloud(path, 0.0, n, 3)
        np.testing.assert_array_equal(got[0], ref[0])
        assert len(got[0]) == (n or 500)
        if with_normals:
            np.testing.assert_array_equal(got[1], ref[1])
        else:
            assert got[1] is None and ref[1] is None


def test_sdf_decoder_matches_jax(tmp_path):
    cfg = jw.DTUPointsConfig(decoder_type="sdf", total_iters=2, warm_up=2,
                             n_iso_points=200, batch_size=256)
    hist, jhist, dec, _, counts, jcounts = run_both(cfg, tmp_path, mesh=False)
    assert type(dec).__name__ == "SDFField" and dec.hidden_size == 512
    assert counts == jcounts == {}
    for i in (0, 1):
        assert_terms(hist[i], jhist[i], 1e-5)


def test_entry_on_cpu_writes_iso_points_and_mesh(tmp_path):
    out = str(tmp_path / "run")
    decoder, info = entry.main([
        "synthetic:torus", "--device", "cpu", "--n-points", "1500",
        "--total-iters", "4", "--warm-up", "1", "--resample-every", "2",
        "--n-iso-points", "150", "--batch-size", "200", "--mesh-resolution",
        "24", "--out-dir", out])
    assert sorted(os.listdir(out)) == ["0000000001_iso.ply", "0000000003_iso.ply",
                                       "final.ply"]
    assert len(read_ply(os.path.join(out, "0000000003_iso.ply"))["points"]) == \
        int(info["iso_mask"].sum()) > 50
    mesh = read_ply(os.path.join(out, "final.ply"))
    assert len(mesh["faces"]) > 100 and np.isfinite(mesh["points"]).all()
    np.testing.assert_array_equal(mesh["points"], info["mesh"][0])
    assert [h[0] for h in info["history"]] == [0]
    assert all(np.isfinite(v) for v in info["history"][0][2].values())


def test_entry_asks_for_cuda_by_default(monkeypatch, tmp_path):
    assert entry.parse_args(["scan.ply"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["synthetic:torus", "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.fit_point_cloud(np.zeros((10, 3), np.float32), None)
