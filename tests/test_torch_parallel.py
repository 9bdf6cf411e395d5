"""The port's parallel/ (torch.distributed) against the JAX package's
mesh-sharded step, on the CPU with gloo.

Two rank processes (`torch.multiprocessing`, start method spawn, a
`FileStore` under tmp_path; tests/torch_parallel_worker.py) run what the
JAX package runs on its virtual mesh(2); each test has its own time limit.
Both packages start from JAX's parameters (converted) and take the same
full-width draws, rebuilt from the JAX step's key as
isopoints_tpu/parallel/sharding.py and training/trainer.py split it. The
update is clip + Adam(b2 0.99), the trainer's, in both.

Held here (tests/test_parallel.py is the model):
- one step, projected and warm-up: the 2-rank step within float reduction
  order of the port's 1-rank step (loss rtol 1e-5, the other metrics rtol
  1e-4, parameters rtol 1e-5 + atol 1e-6, iso-point buffer rtol 1e-5 + atol
  1e-6, masks equal; JAX's own bars for mesh(8) against mesh(1)), the
  ranks' parameters bit-equal, and the loss terms within rtol 1e-4 + atol
  1e-6 of JAX's mesh(2) step, n_iso equal, the parameters within 1e-6 on
  99.9% of each tensor's entries and all within 2e-4 (Adam's first step
  moves a weight by ~±lr where |g| is near its eps);
- the views-sharded step (each rank passes 4 of 8 views, the step gathers
  them) equal to the replicated one within rtol 1e-5 + atol 1e-6, and
  `form_global_batch` gathering the ranks' shares in rank order;
- `local_view_indices`, `sample_global_view_batch` and `HostShardedViews`
  (JAX's tests; the port draws from a numpy RandomState where JAX draws
  from a key);
- the sharded Newton projection at 2 ranks, capacities 128 and 100 (the
  padding), bit-equal to 1 rank, and within 1e-6 of JAX's with equal masks;
- `train_mvr --n-devices 2` as torchrun launches it: both ranks train, the
  ranks' parameters bit-equal, rank 0's metrics rows against a 1-rank run
  of the same seed (warm-up terms rtol 1e-4, the projected total rtol 2e-2
  and n_iso within 5% of the capacity, the e2e free-running bars); with
  `--multihost` (one view a rank, gathered) the rows equal those of the
  replicated 2-rank run within rtol 1e-5.
"""

import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.core.camera import look_at_view_transform as j_look_at
from isopoints_tpu.models.combined import CombinedConfig as JCombinedConfig
from isopoints_tpu.models.combined import CombinedModel as JCombined
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.implicit import ImplicitConfig as JImplicitConfig
from isopoints_tpu.models.levelset import project_points_newton as j_newton
from isopoints_tpu.ops.images import sample_random_pixels as j_pixels
from isopoints_tpu.parallel import data as jdata
from isopoints_tpu.parallel.sharding import make_mesh as j_make_mesh
from isopoints_tpu.parallel.sharding import make_train_step as j_make_train_step
from isopoints_tpu.rendering.rasterizer import RasterizationSettings as JRaster
from isopoints_torch import train_mvr
from isopoints_torch.convert import params_from_jax
from isopoints_torch.misc.metrics import load_metrics
from isopoints_torch.parallel import data as tdata
from isopoints_torch.parallel.sharding import Mesh, make_mesh
import torch_parallel_worker as worker

N, S = worker.N_RAYS, worker.SIZE
LOSS_KEYS = ("loss", "loss_rgb", "loss_freespace", "loss_occupied",
             "loss_eikonal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spawn(task, inp, tmp_path, timeout):
    """Run `task` on 2 gloo ranks; returns each rank's results. Fails the
    test when the ranks are not done within `timeout` seconds."""
    np.savez(tmp_path / "in.npz", **inp)
    out = str(tmp_path / "out%d.npz")
    ctx = mp.start_processes(worker.run, args=(2, str(tmp_path / "store"), task,
                                               str(tmp_path / "in.npz"), out),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{task}: the 2 ranks did not finish within {timeout} s")
    results = []
    for r in range(2):
        with np.load(out % r) as f:
            results.append({k: f[k] for k in f.files})
    return results


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# one sharded step against one rank and JAX's mesh(2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """tests/test_parallel.py's tiny model, its params and start buffer,
    its one view and its 8-view batch."""
    model = JCombined(JSiren(hidden_size=32, n_layers=1),
                      cfg=JImplicitConfig(proj_max_iters=5),
                      combined_cfg=JCombinedConfig(max_iso_per_batch=64,
                                                   n_points_per_cloud=128,
                                                   visibility_image_size=S),
                      raster_settings=JRaster(image_size=S, tile_size=8,
                                              max_points_per_tile=64))
    params = model.init(jax.random.key(0))
    points, mask = model.init_points(jax.random.key(1))
    R, T = j_look_at([2.0], [10.0], [0.0])
    views = {1: (np.asarray(R), np.asarray(T), np.ones((1, S, S, 3), np.float32) * 0.5,
                 np.ones((1, S, S, 1), np.float32))}
    R8, T8 = j_look_at([2.0] * 8, list(range(0, 360, 45)), [15.0] * 8)
    shade = np.linspace(0.5, 1.0, 8, dtype=np.float32)[:, None, None, None]
    views[8] = (np.asarray(R8), np.asarray(T8),
                np.tile(views[1][2], (8, 1, 1, 1)) * shade,
                np.ones((8, S, S, 1), np.float32))
    return model, params, np.asarray(points), np.asarray(mask), views


def jax_step(world, n_dev, project, n_views=1, key=3):
    model, params, points, mask, views = world
    R, T, img, mimg = views[n_views]
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(1e-4, b1=0.9, b2=0.99))
    step = j_make_train_step(model, opt, j_make_mesh(n_dev), project=project,
                             n_rays=N, image_size=(S, S), n_eikonal_points=N)
    hp = {k: jnp.asarray(v, jnp.float32) for k, v in worker.HP.items()}
    return step(params, opt.init(params), jnp.asarray(points), jnp.asarray(mask),
                None, jnp.asarray(img), jnp.asarray(mimg),
                JCam.create(R=R, T=T, focal_length=2.0), hp, jax.random.key(key))


def port_inputs(world, project, n_views=1, key=3):
    """The port's inputs: JAX's params, buffer and views, and the step's
    full-width draws rebuilt from `key` (sharding.py:98-103, trainer.py:
    99-151, combined.py:116,278, raytracing.py:1010)."""
    model, params, points, mask, views = world
    R, T, img, mimg = views[n_views]
    k_pix, k_loss = jax.random.split(jax.random.key(key))
    k1, k2, k3 = jax.random.split(k_loss, 3)
    k_fwd, k_min = jax.random.split(k1)
    k_sel, k_off = jax.random.split(k_fwd)
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params["decoder"])})
    inp = {f"sd:{k}": v.numpy() for k, v in sd.items()}
    inp.update(
        project=np.bool_(project), points=points, points_mask=mask, R=R, T=T,
        img=img, mask=mimg,
        pixels=np.asarray(j_pixels(k_pix, N, (S, S), batch_size=n_views)),
        eikonal=np.asarray(jax.random.uniform(k2, (1, N, 3), minval=-1.0, maxval=1.0)),
        u_minsdf=np.asarray(jax.random.uniform(k_min, (model.raytrace_cfg.n_steps,))),
        ray_uniform=np.asarray(jax.random.uniform(k3, (n_views, N))),
        sel_scores=np.asarray(jax.random.uniform(k_sel, (1, points.shape[1]))),
        iso_offset=np.asarray(jax.random.uniform(
            k_off, (1, model.ccfg.max_iso_per_batch, 3))))
    return inp


def _params_close(a, b, rtol, atol):
    for k in (k for k in a if k.startswith("param:")):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("project", [True, False], ids=["projected", "warm-up"])
def test_two_rank_step_matches_one_rank_and_jax(world, tmp_path, project):
    inp = port_inputs(world, project)
    r0, r1 = spawn("step", inp, tmp_path, timeout=240)
    one = worker.port_step(Mesh(), inp)
    for k in (k for k in r0 if k.startswith("param:")):
        assert np.array_equal(r0[k], r1[k]), k          # replicated update
    np.testing.assert_allclose(r0["metric:loss"], one["metric:loss"],
                               rtol=1e-5, atol=1e-6)
    for k in (k for k in one if k.startswith("metric:")):
        np.testing.assert_allclose(r0[k], one[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _params_close(r0, one, 1e-5, 1e-6)
    np.testing.assert_allclose(r0["points"], one["points"], rtol=1e-5, atol=1e-6)
    assert np.array_equal(r0["points_mask"], one["points_mask"])
    # against JAX's mesh(2) step
    p2, _, pts2, msk2, m2, _ = jax_step(world, 2, project)
    assert float(m2["n_iso"]) > 0 and float(r0["metric:n_iso"]) == float(m2["n_iso"])
    for k in LOSS_KEYS:
        np.testing.assert_allclose(r0[f"metric:{k}"], float(m2[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    ref = params_from_jax({"decoder": jax.tree.map(np.asarray, p2["decoder"])})
    for k, v in ref.items():
        d = np.abs(r0[f"param:decoder.{k.split('.', 1)[1]}"] - v.numpy())
        assert (d > 1e-6).mean() <= 1e-3 and d.max() <= 2e-4, (k, d.max())
    assert np.array_equal(r0["points_mask"], np.asarray(msk2))
    np.testing.assert_allclose(r0["points"], np.asarray(pts2), rtol=1e-5, atol=1e-5)


def test_views_sharded_matches_replicated(world, tmp_path):
    """8 views: each rank passes 4 and the step gathers them, against the
    step given all 8 on both ranks (tests/test_parallel.py:121)."""
    inp = port_inputs(world, True, n_views=8)
    for d in ("rep", "shd"):
        (tmp_path / d).mkdir()
    rep = spawn("step", inp, tmp_path / "rep", timeout=240)[0]
    shd0, shd1 = spawn("step_views", inp, tmp_path / "shd", timeout=240)
    np.testing.assert_allclose(shd0["metric:loss"], rep["metric:loss"],
                               rtol=1e-5, atol=1e-6)
    _params_close(shd0, rep, 1e-5, 1e-6)
    np.testing.assert_allclose(shd0["points"], rep["points"], rtol=1e-5, atol=1e-6)
    x = np.arange(8 * 4 * 4, dtype=np.float32).reshape(8, 4, 4)
    assert np.array_equal(shd0["gathered"], x) and np.array_equal(shd1["gathered"], x)


# ---------------------------------------------------------------------------
# views over the ranks (tests/test_parallel.py:153-196)
# ---------------------------------------------------------------------------

def test_local_view_indices_partition():
    gidx = list(range(16))
    for lvi in (jdata.local_view_indices, tdata.local_view_indices):
        parts = [lvi(gidx, process_index=i, process_count=4) for i in range(4)]
        np.testing.assert_array_equal(np.concatenate(parts), gidx)
        with pytest.raises(ValueError):
            lvi(gidx[:10], process_index=0, process_count=4)
    assert [list(tdata.local_view_indices(gidx, i, 4)) for i in range(4)] == \
        [list(jdata.local_view_indices(gidx, i, 4)) for i in range(4)]


def test_form_global_batch_without_a_group():
    """One rank: the tree comes back as tensors, the camera a camera (the
    gathered layout of 2 ranks is held in the views-sharded test)."""
    from isopoints_torch.core.camera import PerspectiveCamera
    x = np.arange(8 * 4 * 4, dtype=np.float32).reshape(8, 4, 4)
    cam = PerspectiveCamera.create(R=np.eye(3, dtype=np.float32)[None].repeat(8, 0))
    g = tdata.form_global_batch({"img": x, "camera": cam}, Mesh())
    assert isinstance(g["img"], torch.Tensor) and g["img"].shape == (8, 4, 4)
    np.testing.assert_array_equal(g["img"].numpy(), x)
    assert isinstance(g["camera"], PerspectiveCamera)
    assert torch.equal(g["camera"].R, cam.R)


def test_sample_global_view_batch():
    a = tdata.sample_global_view_batch(np.random.RandomState(5), 12, 4)
    b = tdata.sample_global_view_batch(5, 12, 4)
    assert np.array_equal(a, b) and len(set(a)) == 4 and a.max() < 12
    c = tdata.sample_global_view_batch(5, 3, 8)          # more than the views
    assert c.shape == (8,) and c.max() < 3
    ref = np.asarray(jdata.sample_global_view_batch(jax.random.key(5), 12, 4))
    assert len(set(ref)) == 4                           # JAX's, also without replacement


def test_host_sharded_views_iterator():
    class FakeDataset:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            return (np.full((4, 4, 3), float(i), np.float32),
                    np.ones((4, 4, 1), np.float32))

    for mod in (jdata, tdata):
        a = mod.HostShardedViews(FakeDataset(), global_batch=4, seed=5,
                                 process_index=0, process_count=2)
        b = mod.HostShardedViews(FakeDataset(), global_batch=4, seed=5,
                                 process_index=1, process_count=2)
        ia, (img_a, _) = a.next_local()
        ib, (img_b, _) = b.next_local()
        assert img_a.shape == (2, 4, 4, 3) and img_b.shape == (2, 4, 4, 3)
        assert set(ia).isdisjoint(set(ib))
        np.testing.assert_array_equal(img_a[:, 0, 0, 0], ia.astype(np.float32))


# ---------------------------------------------------------------------------
# the sharded Newton projection (tests/test_parallel.py:199)
# ---------------------------------------------------------------------------

def test_form_global_batch_keeps_the_clip_planes(tmp_path):
    """A camera with znear 0.5 and zfar 3.0, half of its views on each of 2
    gloo ranks: R, T, the focal lengths and an image batch are gathered in
    rank order as before, and the planes come back as the same floats (JAX
    keeps them static, camera.py:41-42; the all-gather of 0-d tensors
    failed)."""
    rng = np.random.RandomState(9)
    R = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0].astype(np.float32)
    inp = dict(R=R, T=rng.normal(size=(4, 3)).astype(np.float32),
               focal=rng.uniform(1, 2, (4, 2)).astype(np.float32),
               img=rng.uniform(size=(4, 5, 5, 3)).astype(np.float32))
    for r in spawn("camera", inp, tmp_path, timeout=120):
        for k in ("R", "T", "focal", "img"):
            assert np.array_equal(r[k], inp[k]), k
        np.testing.assert_array_equal(r["principal_point"], np.zeros((4, 2)))
        assert r["planes"].tolist() == [0.5, 3.0]
    from isopoints_torch.core.camera import PerspectiveCamera
    one = tdata.form_global_batch(
        PerspectiveCamera.create(R=R, znear=0.5, zfar=3.0), Mesh())
    assert (one.znear, one.zfar) == (0.5, 3.0) and torch.equal(one.R, torch.tensor(R))


def test_newton_sharded_matches_unsharded(tmp_path):
    rng = np.random.RandomState(2)
    inp = {}
    for p in (128, 100):
        inp[f"pts{p}"] = rng.uniform(-0.9, 0.9, (2, p, 3)).astype(np.float32)
        inp[f"mask{p}"] = np.arange(p)[None, :].repeat(2, 0) < (p - 5)
    r0, r1 = spawn("newton", inp, tmp_path, timeout=120)
    one = worker.newton(Mesh(), inp)
    j_sdf = lambda x: jnp.linalg.norm(x, axis=-1) - 0.6
    for p in (128, 100):
        for f in ("points", "normals", "mask"):
            assert np.array_equal(r0[f"{f}{p}"], one[f"{f}{p}"]), (p, f)
            assert np.array_equal(r1[f"{f}{p}"], one[f"{f}{p}"]), (p, f)
        assert one[f"mask{p}"].sum() > 0
        for mesh in (None, j_make_mesh(2)):
            ref = j_newton(j_sdf, jnp.asarray(inp[f"pts{p}"]),
                           jnp.asarray(inp[f"mask{p}"]), max_iters=10,
                           tolerance=1e-5, mesh=mesh)
            assert np.array_equal(np.asarray(ref.mask), one[f"mask{p}"])
            np.testing.assert_allclose(one[f"points{p}"], np.asarray(ref.points),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(one[f"normals{p}"], np.asarray(ref.normals),
                                       rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the entry point under a torchrun-style launch
# ---------------------------------------------------------------------------

ENTRY_CFG = """
data: {type: synthetic, n_views: 4, image_size: 16}
model:
  decoder_kwargs: {hidden_size: 32, n_layers: 1}
  combined_kwargs: {max_iso_per_batch: 64, n_points_per_cloud: 128,
                    visibility_image_size: 16}
renderer:
  raster_params: {image_size: 16, tile_size: 8, max_points_per_tile: 64}
training:
  n_rays: 64
  n_eikonal_points: 64
  warm_up_iters: 2
  resample_every: 1000
  scheduler_init_n_rays: 64
  scheduler_init_n_points_dss: 128
"""


def _rows(out_dir):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in load_metrics(os.path.join(str(out_dir), "metrics.jsonl"))]


def test_train_mvr_on_two_ranks(tmp_path):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(ENTRY_CFG)
    base = [str(cfg), "--device", "cpu", "--max-iters", "4", "--print-every", "100"]
    train_mvr.main(base + ["--out-dir", str(tmp_path / "one")])
    ranks = {}
    for name, extra in (("two", ["--n-devices", "2"]),
                        ("multihost", ["--n-devices", "2", "--multihost"])):
        d = tmp_path / name
        d.mkdir()
        inp = {"port": np.int64(free_port()),
               "argv": np.array(base + ["--out-dir", str(d / "run"), *extra])}
        ranks[name] = spawn("entry", inp, d, timeout=300)
        for r in ranks[name]:
            assert int(r["mesh_size"]) == 2
            assert bool(r["views_sharded"]) == (name == "multihost")
        for k in (k for k in ranks[name][0] if k.startswith("param:")):
            assert np.array_equal(ranks[name][0][k], ranks[name][1][k]), k
    one, two = _rows(tmp_path / "one"), _rows(tmp_path / "two" / "run")
    multi = _rows(tmp_path / "multihost" / "run")
    # one row an iteration: only rank 0 writes
    assert [r["it"] for r in two] == [r["it"] for r in one] == [0, 1, 2, 3]
    for a, b in zip(two, one):
        if a["it"] < 2:
            for k in LOSS_KEYS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-2)
            assert abs(a["n_iso"] - b["n_iso"]) <= 0.05 * 64
    for a, b in zip(multi, two):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


def test_make_mesh_without_a_launch(monkeypatch):
    """No process group and no torchrun environment: one rank, or a
    ValueError that names the launch for more."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert make_mesh(1, "cpu") == make_mesh(None, "cpu") == Mesh()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        make_mesh(2, "cpu")
