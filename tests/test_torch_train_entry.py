"""The port's training entry (isopoints_torch/train_mvr.py) on an MVR
directory, with checkpoints, resume and `--exit-after`, on the CPU.

A tiny lossS configuration (configs/synthetic_sphere_lossS.yml: SIREN 2x64,
256 rays, 512 iso-points; warm_up_iters 2, resample_every 2, a 640-point
start cloud so that the resample changes the buffer's capacity) trains
from a 6-view 32-px torus directory written by the port. Held here:

- `CheckpointIO`: nested state (a state_dict, the Adam NamedTuple, bare
  tensors, numpy arrays, ints) round-trips bit for bit; the non-strict
  load warns and keeps the template on a missing entry or another shape;
  the orbax backend (a torch.distributed.checkpoint directory,
  `<stem>.orbax`) restores the same state bit for bit; an unknown backend
  raises ValueError; `backup_model_best`.
- Resume: 3 + 3 iterations equal 6 uninterrupted ones bit for bit (every
  metrics row but its time stamp, the parameters, the Adam state, the
  iso-point buffer and its spacing, the four saliency arrays, the
  generator state); a resume that runs no iteration writes back the file
  it read, bit for bit, the buffer's capacity adopted from it (without the
  adoption the load keeps the random start cloud); `--exit-after` exits
  with code 3 after a checkpoint holding the steps taken; `--fresh-keys`
  draws differently; a fresh start beside a stale model_best.npz adopts
  nothing; the hang watchdog is armed each iteration and cancelled on
  return and on exit. With `training.checkpoint_backend: orbax` a 3 + 3
  run resumes from model.orbax and ends bit for bit where the npz run of 6
  ends. `--restart-every-resample` exits with code 4 before the resample
  boundaries at 2 and 4 (not at the iteration it resumed from); relaunched
  until done, it ends bit for bit where the uninterrupted run ends, its
  metrics rows, parameters, Adam state, buffer, spacing, saliency state
  (the lossS arm's) and generator state included.
- `saliency_ref_gt` seeds the reference cloud from the data's GT points.
- `MetricsWriter` / `load_metrics` against JAX's; `--n-devices 2` without a
  torchrun launch raises, `--n-devices 0` and `--multihost` run on the one
  rank (tests/test_torch_parallel.py launches two).
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

from isopoints_tpu.misc import metrics as j_metrics
from isopoints_torch import GeneratorChain, create_mvr_data, train_mvr
from isopoints_torch.config import load_config
from isopoints_torch.factories import create_dataset
from isopoints_torch.misc.checkpoints import CheckpointIO
from isopoints_torch.misc.metrics import MetricsWriter, load_metrics
from isopoints_torch.training.trainer import AdamState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = """inherit_from: {root}/configs/synthetic_sphere_lossS.yml
data:
  type: MVR
  data_dir: {data}
model:
  combined_kwargs:
    n_points_per_cloud: 640
training:
  warm_up_iters: 2
  resample_every: 2
  saliency_ref_gt: {ref_gt}
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry")
    data = create_mvr_data.main(["torus", str(root / "data"), "--n-views", "6",
                                 "--image-size", "32", "--device", "cpu"])
    cfgs = {}
    for ref_gt in (False, True):
        path = root / f"cfg_{ref_gt}.yml"
        path.write_text(CFG.format(root=ROOT, data=root / "data", ref_gt=str(ref_gt).lower()))
        cfgs[ref_gt] = str(path)
    return root, cfgs, data


def _train(cfg, out, n, *extra):
    return train_mvr.main([cfg, "--device", "cpu", "--out-dir", str(out),
                           "--max-iters", str(n), "--print-every", "100",
                           "--checkpoint-every", "1000", *extra])


def _rows(out):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in load_metrics(os.path.join(str(out), "metrics.jsonl"))]


def _npz(out, name="model.npz"):
    with np.load(os.path.join(str(out), name)) as f:
        return {k: f[k] for k in f.files}


def _assert_same_npz(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def warnings_seen():
    h = _Warnings()
    log = logging.getLogger("isopoints_torch")
    log.addHandler(h)
    yield h.messages
    log.removeHandler(h)


def test_checkpoint_round_trip_and_non_strict_load(tmp_path, warnings_seen):
    g = torch.Generator().manual_seed(0)
    net = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 1))
    for p in net.parameters():
        nn.init.uniform_(p, generator=g)
    params = dict(net.named_parameters())
    opt = AdamState(7, {k: torch.rand(p.shape, generator=g) for k, p in params.items()},
                    {k: torch.rand(p.shape, generator=g) for k, p in params.items()})
    pts = torch.rand(1, 10, 3, generator=g)
    mask = torch.rand(1, 10, generator=g) > 0.5
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    ck = CheckpointIO(str(tmp_path), model=net.state_dict(), opt=opt, points=pts,
                      points_mask=mask, extra={"a": arr, "n": 3}, none=None)
    path = ck.save("model", it=5, rng_state=np.arange(4, dtype=np.uint8))
    assert path.endswith("model.npz")
    with np.load(path) as f:
        keys = set(f.files)
    assert {"points:", "opt:count", "opt:mu/0.weight", "model:1.bias",
            "extra:a", "scalar:it"} <= keys and not any(k.startswith("none") for k in keys)
    fresh = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 1))
    zeros = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}
    ck2 = CheckpointIO(str(tmp_path), model=fresh.state_dict(),
                       opt=AdamState(0, zeros(opt.mu), zeros(opt.nu)),
                       points=torch.zeros(1, 10, 3), points_mask=torch.zeros(1, 10, dtype=torch.bool),
                       extra={"a": np.zeros((2, 3), np.float32), "n": 0}, none=None)
    scalars = ck2.load("model.npz")
    assert scalars["it"] == 5 and scalars["rng_state"].tolist() == [0, 1, 2, 3]
    fresh.load_state_dict(ck2.registry["model"])
    for k, v in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    got = ck2.registry["opt"]
    assert isinstance(got, AdamState) and got.count == 7 and isinstance(got.count, int)
    for k in opt.mu:
        assert torch.equal(got.mu[k], opt.mu[k]) and torch.equal(got.nu[k], opt.nu[k])
    assert torch.equal(ck2.registry["points"], pts)
    assert ck2.registry["points_mask"].dtype == torch.bool
    assert torch.equal(ck2.registry["points_mask"], mask)
    np.testing.assert_array_equal(ck2.registry["extra"]["a"], arr)
    assert ck2.registry["extra"]["n"] == 3 and ck2.registry["none"] is None
    assert warnings_seen == []
    # non-strict: another shape and a missing entry keep the template
    keep = torch.full((1, 12, 3), 7.0)
    ck3 = CheckpointIO(str(tmp_path), points=keep, new={"b": torch.ones(2)})
    ck3.load("model")
    assert ck3.registry["points"] is keep
    assert torch.equal(ck3.registry["new"]["b"], torch.ones(2))
    assert any("shape mismatch for" in m and "kept model" in m for m in warnings_seen)
    assert any("missing key in checkpoint: b" in m for m in warnings_seen)
    with pytest.raises(FileNotFoundError):
        ck3.load("absent.npz")
    assert ck3.backup_model_best() is None
    shutil.copy(path, tmp_path / "model_best.npz")
    backup = ck3.backup_model_best()
    assert backup is not None and os.path.exists(backup)
    # the orbax backend: a directory at the JAX rule's path, the same state
    ck4 = CheckpointIO(str(tmp_path / "o"), backend="orbax", model=net.state_dict(),
                       opt=opt, points=pts, points_mask=mask,
                       extra={"a": arr, "n": 3}, none=None)
    opath = ck4.save("model.npz", it=5, rng_state=np.arange(4, dtype=np.uint8))
    assert opath == str(tmp_path / "o" / "model.orbax") and os.path.isdir(opath)
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    _assert_same_npz(ck4.read("model"), flat)
    assert {k: v[0] for k, v in ck4.saved_arrays("model").items()} == {
        k: v.shape for k, v in flat.items()}
    ck5 = CheckpointIO(str(tmp_path / "o"), backend="orbax",
                       model=fresh.state_dict(),
                       opt=AdamState(0, zeros(opt.mu), zeros(opt.nu)),
                       points=torch.zeros(1, 10, 3),
                       points_mask=torch.zeros(1, 10, dtype=torch.bool),
                       extra={"a": np.zeros((2, 3), np.float32), "n": 0}, none=None)
    o_scalars = ck5.load("model.npz")
    assert o_scalars["it"] == 5 and o_scalars["rng_state"].tolist() == [0, 1, 2, 3]
    got = ck5.registry["opt"]
    assert got.count == 7 and isinstance(got.count, int)
    for k in opt.mu:
        assert torch.equal(got.mu[k], opt.mu[k]) and torch.equal(got.nu[k], opt.nu[k])
    assert torch.equal(ck5.registry["points"], pts)
    assert torch.equal(ck5.registry["points_mask"], mask)
    assert ck5.registry["extra"]["n"] == 3
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        CheckpointIO(str(tmp_path), backend="pickle")


def test_generator_chain_state_round_trip():
    a = GeneratorChain(3)
    a.next()
    snap = a.state()
    draws = [torch.rand(4, generator=a.next()) for _ in range(3)]
    b = GeneratorChain(99)
    b.set_state(snap)
    for d in draws:
        assert torch.equal(torch.rand(4, generator=b.next()), d)


def test_resumed_run_equals_uninterrupted(setup, tmp_path):
    _, cfgs, _ = setup
    run = _train(cfgs[False], tmp_path / "full", 6)
    _train(cfgs[False], tmp_path / "resumed", 3)
    resumed = _train(cfgs[False], tmp_path / "resumed", 6)
    rows = _rows(tmp_path / "full")
    assert [r["it"] for r in rows] == list(range(6))
    assert _rows(tmp_path / "resumed") == rows
    full, res = _npz(tmp_path / "full"), _npz(tmp_path / "resumed")
    _assert_same_npz(full, res)
    # every piece of state is in the file: saliency, buffer, spacing, rng
    for k in ("saliency:ref_points", "saliency:ref_stat_mean", "saliency:ref_stat_n",
              "saliency:ref_mask", "points:", "points_mask:", "spacing:",
              "scalar:rng_state", "opt:count"):
        assert k in full, k
    # the buffer keeps the visible subset: max_iso_per_batch (256) points
    assert int(full["scalar:it"]) == 6 and full["points:"].shape == (1, 256, 3)
    assert resumed.state.it == run.state.it == 6
    assert torch.equal(resumed.trainer.ref_stat_mean, run.trainer.ref_stat_mean)


def test_resume_adopts_the_capacity_and_restores_bit_for_bit(setup, tmp_path,
                                                             warnings_seen):
    _, cfgs, _ = setup
    _train(cfgs[False], tmp_path, 4)
    saved = _npz(tmp_path)
    assert saved["points:"].shape == (1, 256, 3)       # the start cloud: 640
    run = _train(cfgs[False], tmp_path, 4)               # resumes, runs nothing
    _assert_same_npz(_npz(tmp_path), saved)
    assert run.state.points.shape == (1, 256, 3)
    np.testing.assert_array_equal(run.state.points.numpy(), saved["points:"])
    np.testing.assert_array_equal(run.trainer.generators.state(),
                                  saved["scalar:rng_state"])
    np.testing.assert_array_equal(run.trainer.ref_points.numpy(),
                                  saved["saliency:ref_points"])
    assert not any("mismatch" in m for m in warnings_seen)
    # without the adoption the non-strict load keeps the random start cloud
    start = torch.zeros(1, 640, 3)
    ck = CheckpointIO(str(tmp_path), points=start)
    ck.load("model.npz")
    assert ck.registry["points"] is start
    assert any("shape mismatch for" in m for m in warnings_seen)


def test_exit_after_checkpoints_and_exits_3(setup, tmp_path):
    _, cfgs, _ = setup
    with pytest.raises(SystemExit) as e:
        _train(cfgs[False], tmp_path, 6, "--exit-after", "1e-9")
    assert e.value.code == 3
    saved = _npz(tmp_path)
    assert int(saved["scalar:it"]) == 1 == len(_rows(tmp_path))
    run = _train(cfgs[False], tmp_path, 3)               # resumes at it 1
    assert run.state.it == 3 and [r["it"] for r in _rows(tmp_path)] == [0, 1, 2]


def test_fresh_keys_draw_differently(setup, tmp_path):
    _, cfgs, _ = setup
    _train(cfgs[False], tmp_path / "a", 4)
    _train(cfgs[False], tmp_path / "b", 3)
    _train(cfgs[False], tmp_path / "b", 4, "--fresh-keys")
    a, b = _rows(tmp_path / "a"), _rows(tmp_path / "b")
    assert a[:3] == b[:3] and a[3] != b[3]


def test_fresh_start_beside_a_stale_best_model(setup, tmp_path):
    _, cfgs, _ = setup
    _train(cfgs[False], tmp_path / "old", 4)
    os.makedirs(tmp_path / "new")
    shutil.copy(tmp_path / "old" / "model.npz", tmp_path / "new" / "model_best.npz")
    _train(cfgs[False], tmp_path / "new", 3)
    _train(cfgs[False], tmp_path / "clean", 3)
    assert _rows(tmp_path / "new") == _rows(tmp_path / "clean")
    _assert_same_npz(_npz(tmp_path / "new"), _npz(tmp_path / "clean"))


def test_watchdog_armed_and_cancelled(setup, tmp_path, monkeypatch):
    _, cfgs, _ = setup
    calls = []
    monkeypatch.setattr(train_mvr.faulthandler, "dump_traceback_later",
                        lambda *a, **kw: calls.append(("arm", a, kw)))
    monkeypatch.setattr(train_mvr.faulthandler, "cancel_dump_traceback_later",
                        lambda: calls.append(("cancel",)))
    monkeypatch.setenv("ISOPOINTS_WATCHDOG_S", "77")
    _train(cfgs[False], tmp_path / "a", 2)
    assert [c[0] for c in calls] == ["arm", "arm", "cancel"]
    assert calls[0][1] == (77,) and calls[0][2] == {"repeat": True, "exit": True}
    calls.clear()
    with pytest.raises(SystemExit):
        _train(cfgs[False], tmp_path / "b", 3, "--exit-after", "1e-9")
    assert [c[0] for c in calls] == ["arm", "cancel"]
    calls.clear()
    monkeypatch.setenv("ISOPOINTS_WATCHDOG_S", "0")
    _train(cfgs[False], tmp_path / "c", 1)
    assert calls == []


def test_orbax_backend_resumes_bit_for_bit(setup, tmp_path):
    """A lossS run with `checkpoint_backend: orbax`, 3 + 3 iterations,
    against the npz run of 6: the rows and every checkpoint entry equal."""
    _, cfgs, _ = setup
    cfg = tmp_path / "orbax.yml"
    with open(cfgs[False]) as f:
        cfg.write_text(f.read().replace("training:\n", "training:\n  checkpoint_backend: orbax\n"))
    _train(str(cfg), tmp_path / "o", 3)
    assert os.path.isdir(tmp_path / "o" / "model.orbax")
    assert not os.path.exists(tmp_path / "o" / "model.npz")
    _train(str(cfg), tmp_path / "o", 6)
    _train(cfgs[False], tmp_path / "n", 6)
    assert _rows(tmp_path / "o") == _rows(tmp_path / "n")
    saved = CheckpointIO(str(tmp_path / "o"), backend="orbax").read("model")
    _assert_same_npz(saved, _npz(tmp_path / "n"))


def test_restart_every_resample(setup, tmp_path):
    _, cfgs, _ = setup
    exits = []
    while True:
        try:
            run = _train(cfgs[False], tmp_path / "r", 6, "--restart-every-resample")
            break
        except SystemExit as e:
            assert e.code == 4
            exits.append(int(_npz(tmp_path / "r")["scalar:it"]))
    assert exits == [2, 4] and run.state.it == 6
    full = _train(cfgs[False], tmp_path / "full", 6)
    assert _rows(tmp_path / "r") == _rows(tmp_path / "full")
    _assert_same_npz(_npz(tmp_path / "r"), _npz(tmp_path / "full"))
    assert "saliency:ref_stat_mean" in _npz(tmp_path / "r")
    assert torch.equal(run.trainer.ref_stat_mean, full.trainer.ref_stat_mean)


def test_saliency_reference_from_gt_points(setup, tmp_path):
    _, cfgs, data = setup
    run = _train(cfgs[True], tmp_path / "gt", 1)         # warm-up only
    ref, ok = run.trainer.ref_points[0], run.trainer.ref_mask[0]
    gt = torch.from_numpy(data["points"])
    assert int(ok.sum()) == ref.shape[0] == min(512, len(gt))
    d = torch.cdist(ref, gt, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1).values
    assert float(d.max()) == 0.0                         # FPS picks GT points
    assert float(run.trainer.ref_stat_n.max()) == 0.0
    off = _train(cfgs[False], tmp_path / "own", 1)
    assert off.trainer.ref_points is None                # seeded at it 2


def test_metrics_writer_against_jax(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.log(0, {"loss": torch.tensor(0.5), "n": 3, "name": "skip", "none": None})
    w.log(1, {"iou": np.float32(0.25)}, prefix="eval_")
    w.close()
    rows = j_metrics.load_metrics(w.path)
    assert rows == load_metrics(w.path) == w.history
    assert [sorted(r) for r in rows] == [["it", "loss", "n", "ts"],
                                         ["eval_iou", "it", "ts"]]
    assert rows[0]["loss"] == 0.5 and rows[1]["eval_iou"] == 0.25
    j = j_metrics.MetricsWriter(str(tmp_path), "jax.jsonl")
    j.log(4, {"loss": 1.5, "bad": "x"})
    j.close()
    assert load_metrics(j.path) == j_metrics.load_metrics(j.path)


@pytest.mark.parametrize("flags,match", [
    (["--n-devices", "2"], "torchrun"), (["--n-devices", "0"], None),
    (["--multihost"], None)])
def test_unported_flags_raise(setup, tmp_path, flags, match):
    """The multi-device flags without a torchrun launch: N > 1 devices raise
    ValueError naming the launch; every rank (0) and `--multihost` take the
    one rank there is and train as without them."""
    _, cfgs, _ = setup
    if match is not None:
        with pytest.raises(ValueError, match=match):
            _train(cfgs[False], tmp_path, 1, *flags)
        return
    run = _train(cfgs[False], tmp_path, 1, *flags)
    assert run.trainer.mesh.size == 1 and not run.trainer.views_sharded
    rows = _rows(tmp_path)
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])


def test_unported_data_raises(setup, tmp_path):
    # `mesh` is ported: without --mesh, or with --dtu, it is a usage error
    for extra in ([], ["--mesh", str(tmp_path / "m.ply"), "--dtu"]):
        with pytest.raises(SystemExit) as e:
            create_mvr_data.main(["mesh", str(tmp_path / "m"), "--device", "cpu",
                                  *extra])
        assert e.value.code == 2
    cfg = load_config(setup[1][False])
    cfg.data.type = "Blender"
    with pytest.raises(ValueError, match="unknown dataset type"):
        create_dataset(cfg, device="cpu")


@pytest.mark.parametrize("name,arm,data,cuts", [
    ("mvr_lossS_dir.yml", "ablation_compound_lossS.yml",
     {"type": "MVR", "data_dir": "out/torch_data_torus512"},
     {"warm_up_iters": 2, "resample_every": 2}),
    ("mvr_uni_dtu.yml", "ablation_compound_uni.yml",
     {"type": "DTU", "data_dir": "out/torch_data_dtu_torus"},
     {"warm_up_iters": 2})] + [
    (f"ablation_compound_{a}_dir.yml", f"ablation_compound_{a}.yml",
     {"type": "MVR", "data_dir": "out/torch_data_compound"}, {})
    for a in ("implicit", "uni", "lossS")])
def test_directory_configs_are_the_arms(name, arm, data, cuts):
    """The directory configs are their ablation arm at full width, read
    as train_mvr.py reads it, but for the data directory, the kernel rasters
    and the schedule cuts their headers state."""
    from isopoints_tpu.config import default_config_path, load_config as j_load
    got = load_config(os.path.join(ROOT, "isopoints_torch", "configs", name),
                      default_config_path()).to_dict()
    ref = j_load(os.path.join(ROOT, "configs", arm), default_config_path()).to_dict()
    assert {k: got["data"][k] for k in data} == data
    assert got["renderer"]["raster_params"].pop("use_pallas") is True
    for k, v in cuts.items():
        assert got["training"].pop(k) == v
        ref["training"].pop(k)
    for c in (got, ref):
        c.pop("inherit_from", None)
        c.pop("data")
    assert got == ref
