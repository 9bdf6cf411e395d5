"""Port parity of the saliency ("lossS") arm against the JAX package, on
the CPU: farthest point sampling, the local frames, the insertion around
salient reference points, the append into free capacity, `project_points`
with insertion, the reference cloud's running statistics (both modes), the
saliency state, the factory on the lossS configs, and the lossS training
trajectory through an inserting resample.

Inputs are made with numpy from seeds and handed to both packages; the
SIREN is initialised by the JAX package and converted.

Tolerances. Exact (equal): FPS index sets and masks; the children of
`insert_around_salient` and their mask (the same float32 operations in the
same order: the kNN's fma forms, true division by 3, `jnp.nanmedian`'s
midpoint, `lax.top_k`'s tie order); `_append_into_capacity`; the counts of
the running statistics. `project_points` with insertion: masks equal,
points within 1e-5 (the Newton iterations of the two packages' SIRENs
differ by float rounding). Running means within 1e-6 (the 8-neighbour sums
in another order). Local frames: eigenvalues within 1e-5, eigenvectors up
to sign, |dot| >= 1 - 1e-5 where both gaps to the other eigenvalues exceed
1e-4 (an eigenvector of a near-double eigenvalue is not determined). The
curvature metric within 1e-4 relative. The trajectories state theirs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.config import default_config_path, load_config as j_load
from isopoints_tpu.factories import create_model as j_create_model
from isopoints_tpu.factories import create_trainer as j_create_trainer
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.levelset import ProjectionConfig as JProjCfg
from isopoints_tpu.models.levelset import _append_into_capacity as j_append
from isopoints_tpu.models.levelset import insert_around_salient as j_insert
from isopoints_tpu.models.levelset import project_points as j_project
from isopoints_tpu.ops.sampling import farthest_point_sampling as j_fps
from isopoints_tpu.ops.sampling import fps_subsample as j_fps_subsample
from isopoints_tpu.utils import mathutils as j_math
from isopoints_torch import factories
from isopoints_torch.config import load_config
from isopoints_torch.convert import params_from_jax
from isopoints_torch.models import levelset
from isopoints_torch.models.fields import SirenField
from isopoints_torch.models.levelset import (ProjectionConfig,
                                             _append_into_capacity,
                                             insert_around_salient,
                                             project_points)
from isopoints_torch.ops import fused_mlp
from isopoints_torch.ops.sampling import farthest_point_sampling, fps_subsample
from isopoints_torch.utils import mathutils
from test_torch_e2e import LOSS_KEYS, _run_projected


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_S = os.path.join(ROOT, "configs", "synthetic_sphere_lossS.yml")
T = torch.from_numpy


def _sphere(rng, shape, r=0.5, noise=0.0):
    v = rng.normal(size=shape + (3,))
    v = r * v / np.linalg.norm(v, axis=-1, keepdims=True)
    return (v + noise * rng.normal(size=v.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# farthest point sampling
# ---------------------------------------------------------------------------

def _fps_case(case):
    """(points (2, P, 3), mask, n_samples) of a named case."""
    rng = np.random.RandomState(case)
    pts = rng.uniform(-1, 1, (2, 400, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 400)) < 0.8
    if case == 1:       # exact duplicates: each point three times
        pts = np.concatenate([pts[:, :130]] * 3, 1)[:, rng.permutation(390)]
        mask = mask[:, :390]
    elif case == 2:     # a lattice: many equal distances
        g = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"), -1)
        pts = np.stack([g.reshape(-1, 3)] * 2).astype(np.float32) / 4.0
        mask = rng.uniform(size=pts.shape[:2]) < 0.9
    elif case == 3:     # one cloud all masked
        mask[0] = False
    elif case == 4:     # fewer valid points than samples
        mask[:] = False
        mask[0, rng.choice(400, 20, replace=False)] = True
        mask[1, rng.choice(400, 45, replace=False)] = True
        return pts, mask, 64
    return pts, mask, 128


@pytest.mark.parametrize("case", range(5), ids=["masked", "duplicates",
                                                "lattice", "all-masked",
                                                "n-above-valid"])
def test_fps_matches_jax(case):
    pts, mask, n = _fps_case(case)
    j_idx, j_ok = j_fps(jnp.asarray(pts), n, jnp.asarray(mask))
    idx, ok = farthest_point_sampling(T(pts), n, T(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))


@pytest.mark.parametrize("case", [0, 3])
def test_fps_start_idx_is_not_read(case):
    """JAX's FPS takes `start_idx` and never reads it (sampling.py:21,
    40-42): the first pick is the first valid index whatever it is, in
    both packages."""
    pts, mask, n = _fps_case(case)
    for start in (0, 7):
        j_idx, j_ok = j_fps(jnp.asarray(pts), n, jnp.asarray(mask), start_idx=start)
        idx, ok = farthest_point_sampling(T(pts), n, T(mask), start_idx=start)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
        base, _ = farthest_point_sampling(T(pts), n, T(mask))
        assert torch.equal(idx, base)


@pytest.mark.parametrize("ratio", [0.25, 0.5])
@pytest.mark.parametrize("case", [0, 3, 4])
def test_fps_subsample_matches_jax(case, ratio):
    pts, mask, _ = _fps_case(case)
    j_out = j_fps_subsample(jnp.asarray(pts), ratio, jnp.asarray(mask))
    out = fps_subsample(T(pts), ratio, T(mask))
    for a, b in zip(out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# local frames and curvature
# ---------------------------------------------------------------------------

def test_local_coord_frames_match_jax():
    rng = np.random.RandomState(3)
    pts = _sphere(rng, (2, 300), noise=0.01)
    nn = (pts[:, :, None, :] + rng.normal(0, 0.05, (2, 300, 12, 3))
          * np.array([1.0, 1.0, 0.2])).astype(np.float32)
    nn_mask = rng.uniform(size=(2, 300, 12)) < 0.85
    j_ev, j_vec = j_math.local_coord_frames(jnp.asarray(pts), jnp.asarray(nn),
                                            jnp.asarray(nn_mask))
    ev, vec = mathutils.local_coord_frames(T(pts), T(nn), T(nn_mask))
    j_ev, j_vec = np.array(j_ev), np.array(j_vec)
    np.testing.assert_allclose(ev.numpy(), j_ev, atol=1e-5, rtol=0)
    gaps = np.abs(j_ev[..., :, None] - j_ev[..., None, :]) + np.eye(3) * 1.0
    separated = gaps.min(-1) > 1e-4                            # (2, P, 3)
    dots = np.abs(np.sum(vec.numpy() * j_vec, axis=-2))        # per column
    assert separated.mean() > 0.9
    assert (dots[separated] >= 1 - 1e-5).all()
    # normals and the curvature proxy
    j_n = j_math.estimate_normals(jnp.asarray(pts), jnp.asarray(nn),
                                  jnp.asarray(nn_mask))
    n = mathutils.estimate_normals(T(pts), T(nn), T(nn_mask))
    sep0 = separated[..., 0]
    np.testing.assert_allclose(n.numpy()[sep0], np.asarray(j_n)[sep0], atol=1e-5)
    np.testing.assert_allclose(mathutils.curvature_proxy(ev).numpy(),
                               np.asarray(j_math.curvature_proxy(jnp.asarray(j_ev))),
                               atol=1e-6)
    view = np.array([0.0, 0.0, 2.0], np.float32)
    np.testing.assert_array_equal(
        mathutils.disambiguate_normals(T(j_vec[..., 0]), T(pts), T(view)).numpy(),
        np.asarray(j_math.disambiguate_normals(jnp.asarray(j_vec[..., 0]),
                                               jnp.asarray(pts), jnp.asarray(view))))


# ---------------------------------------------------------------------------
# insertion and append
# ---------------------------------------------------------------------------

def _salient_case(case):
    """(points, mask, ref_points, ref_metric, ref_mask) of a named case,
    B = 2."""
    rng = np.random.RandomState(10 + case)
    pts = _sphere(rng, (2, 300))
    mask = rng.uniform(size=(2, 300)) < 0.9
    ref = _sphere(rng, (2, 120))
    ref_mask = rng.uniform(size=(2, 120)) < 0.8
    metric = rng.uniform(0, 1, (2, 120)).astype(np.float32)
    if case == 1:       # ties in the metric
        metric = np.round(metric * 3) / 3
    elif case == 2:     # one cloud's reference all masked (all-NaN median)
        ref_mask[0] = False
    elif case == 3:     # no hot point: every metric 0
        metric[:] = 0.0
    elif case == 4:     # few hot points, and few valid reference points
        metric = metric * (rng.uniform(size=metric.shape) < 0.05)
        ref_mask[1, 30:] = False
    return pts, mask, ref, metric, ref_mask


@pytest.mark.parametrize("case", range(5), ids=["random", "ties", "all-masked",
                                                "no-hot", "few-hot"])
def test_insert_around_salient_matches_jax(case):
    args = _salient_case(case)
    j_c, j_m = j_insert(*(jnp.asarray(a) for a in args))
    c, m = insert_around_salient(*(T(a) for a in args))
    np.testing.assert_array_equal(m.numpy(), np.asarray(j_m))
    np.testing.assert_array_equal(c.numpy(), np.asarray(j_c))
    assert np.asarray(j_m).sum() > 0
    if case == 2:
        assert np.asarray(j_m)[0].sum() == 0


@pytest.mark.parametrize("n_new,frac", [(40, 0.5), (200, 0.9)],
                         ids=["fits", "overflow"])
def test_append_into_capacity_matches_jax(n_new, frac):
    rng = np.random.RandomState(n_new)
    cap = 160
    pts, nrm = (rng.normal(size=(2, cap, 3)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(2, cap)) < frac
    new, new_n = (rng.normal(size=(2, n_new, 3)).astype(np.float32) for _ in range(2))
    new_mask = rng.uniform(size=(2, n_new)) < 0.7
    args = (pts, mask, nrm, new, new_mask, new_n)
    j_out = j_append(*(jnp.asarray(a) for a in args))
    out = _append_into_capacity(*(T(a) for a in args))
    for a, b in zip(out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    total = mask.sum(-1) + new_mask.sum(-1)
    np.testing.assert_array_equal(out[1].numpy().sum(-1), np.minimum(total, cap))
    assert (total > cap).any() == (n_new == 200)


def _siren_pair():
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(1))
    field = SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    field.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()})
    return (lambda x: jfield.sdf(params, x)), fused_mlp.make_fused_siren_sdf(field)


def test_project_points_with_insertion_matches_jax():
    """The saliency branch: Newton at the config's iterations, children
    around the hot reference points, their Newton (10 iterations), the
    append. Masks equal, points within 1e-5."""
    j_sdf, t_sdf = _siren_pair()
    rng = np.random.RandomState(21)
    pts = rng.uniform(-0.75, 0.75, (1, 400, 3)).astype(np.float32)
    mask = rng.uniform(size=(1, 400)) < 0.7         # free capacity to fill
    # the reference cloud: another cloud projected onto the same surface
    ref0 = rng.uniform(-0.75, 0.75, (1, 100, 3)).astype(np.float32)
    ref = project_points(t_sdf, T(ref0), torch.ones(1, 100, dtype=torch.bool),
                         skip_resampling=True)
    ref_pts, ref_mask = ref.points.numpy(), ref.mask.numpy()
    metric = rng.uniform(0, 1, (1, 100)).astype(np.float32)
    kw = dict(skip_resampling=True, skip_upsampling=False)
    j_res = j_project(j_sdf, jnp.asarray(pts), jnp.asarray(mask), JProjCfg(),
                      ref_points=jnp.asarray(ref_pts),
                      ref_metric=jnp.asarray(metric),
                      ref_mask=jnp.asarray(ref_mask), **kw)
    res = project_points(t_sdf, T(pts), T(mask), ProjectionConfig(),
                         ref_points=T(ref_pts), ref_metric=T(metric),
                         ref_mask=T(ref_mask), **kw)
    plain = project_points(t_sdf, T(pts), T(mask), skip_resampling=True)
    jm = np.asarray(j_res.mask)
    np.testing.assert_array_equal(res.mask.numpy(), jm)
    assert jm.sum() > plain.mask.sum() > 0          # children were appended
    np.testing.assert_allclose(res.points.numpy()[jm], np.asarray(j_res.points)[jm],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.normals.numpy()[jm],
                               np.asarray(j_res.normals)[jm], atol=1e-4, rtol=1e-4)


def test_project_points_unported_branches_raise():
    """Without a reference cloud the upsampling branches run (midpoint, or
    edge-aware with `edge_aware`), where they raised before they were
    ported; a reference cloud still takes the insertion."""
    _, t_sdf = _siren_pair()
    rng = np.random.RandomState(22)
    pts = T(rng.uniform(-0.75, 0.75, (1, 200, 3)).astype(np.float32))
    mask = torch.ones(1, 200, dtype=torch.bool)
    plain = project_points(t_sdf, pts, mask, skip_resampling=True)
    for edge_aware in (False, True):
        res = project_points(t_sdf, pts, mask, skip_resampling=True,
                             skip_upsampling=False, edge_aware=edge_aware)
        assert res.points.shape == pts.shape
        assert int(res.mask.sum()) >= int(plain.mask.sum())
    assert not hasattr(levelset, "_NOT_PORTED")


# ---------------------------------------------------------------------------
# the reference cloud's statistics and state
# ---------------------------------------------------------------------------

def _trainers(mode="loss"):
    jcfg = j_load(LOSS_S, default_config_path())
    tcfg = load_config(LOSS_S, default_config_path())
    jcfg.training.saliency_mode = mode
    tcfg.training.saliency_mode = mode
    jt = j_create_trainer(j_create_model(jcfg), jcfg, seed=0)
    tt = factories.create_trainer(factories.create_model(tcfg, device="cpu"),
                                  tcfg, seed=0, device="cpu")
    return jt, tt


def _assert_state_close(tt, jt, atol_mean):
    j_state = jax.tree.map(np.asarray, jt.saliency_state())
    state = tt.saliency_state()
    for k in ("ref_points", "ref_mask", "ref_stat_n"):
        np.testing.assert_array_equal(state[k], j_state[k], err_msg=k)
    np.testing.assert_allclose(state["ref_stat_mean"], j_state["ref_stat_mean"],
                               atol=atol_mean, rtol=0)


def test_update_ref_metric_matches_jax():
    """Seeding by FPS of the first view's iso set, then three masked
    Welford updates; one with an all-masked view and one with no valid
    iso-point at all (no count moves)."""
    jt, tt = _trainers()
    rng = np.random.RandomState(4)
    for step in range(4):
        iso = _sphere(rng, (2, 256), noise=0.01)
        loss = rng.uniform(0, 1, (2, 256)).astype(np.float32)
        iso_mask = rng.uniform(size=(2, 256)) < 0.6
        if step == 2:
            iso_mask[1] = False
        if step == 3:
            iso_mask[:] = False
        jt.update_ref_metric(jnp.asarray(iso), jnp.asarray(loss),
                             jnp.asarray(iso_mask))
        tt.update_ref_metric(T(iso), T(loss), T(iso_mask))
        _assert_state_close(tt, jt, 1e-6)
    n = tt.saliency_state()["ref_stat_n"]
    assert n.shape == (1, 256) and n.max() == 3 and n.min() < 3


def test_curvature_metric_matches_jax():
    jt, tt = _trainers("curvature")
    rng = np.random.RandomState(8)
    gt = _sphere(rng, (900,), noise=0.004)
    jt.set_reference_cloud(gt)
    tt.set_reference_cloud(gt)
    j_state = jax.tree.map(np.asarray, jt.saliency_state())
    state = tt.saliency_state()
    for k in ("ref_points", "ref_mask", "ref_stat_n"):
        np.testing.assert_array_equal(state[k], j_state[k], err_msg=k)
    assert state["ref_points"].shape == (1, 512, 3)
    np.testing.assert_allclose(state["ref_stat_mean"], j_state["ref_stat_mean"],
                               rtol=1e-4, atol=0)
    assert state["ref_stat_mean"].max() > 0
    # the metric is static: an update leaves it as it is
    iso = T(_sphere(rng, (2, 64)))
    tt.update_ref_metric(iso, torch.ones(2, 64), torch.ones(2, 64, dtype=torch.bool))
    np.testing.assert_array_equal(tt.saliency_state()["ref_stat_mean"],
                                  state["ref_stat_mean"])


def test_saliency_state_round_trip_and_shape_check():
    _, tt = _trainers()
    assert tt.saliency_state() is None
    rng = np.random.RandomState(2)
    tt.update_ref_metric(T(_sphere(rng, (2, 100))),
                         T(rng.uniform(size=(2, 100)).astype(np.float32)),
                         torch.ones(2, 100, dtype=torch.bool))
    state = tt.saliency_state()
    assert all(isinstance(v, np.ndarray) for v in state.values())
    _, other = _trainers()
    other.load_saliency_state(state)
    for k, v in other.saliency_state().items():
        np.testing.assert_array_equal(v, state[k])
    assert other.ref_mask.dtype == torch.bool
    assert other.ref_points.device == other.device
    for k, bad in (("ref_stat_n", np.zeros((1, 99), np.float32)),
                   ("ref_mask", np.ones((2, 100), bool)),
                   ("ref_points", np.zeros((1, 100, 2), np.float32))):
        with pytest.raises(ValueError, match="shapes disagree"):
            other.load_saliency_state({**state, k: bad})


@pytest.mark.parametrize("cfg,n_ref", [
    ("configs/ablation_compound_lossS.yml", 4096),
    ("configs/synthetic_sphere_lossS.yml", 512),
    ("isopoints_torch/configs/mvr_lossS_siren.yml", 4096)])
def test_create_trainer_keeps_saliency_keys(cfg, n_ref):
    c = load_config(os.path.join(ROOT, cfg), default_config_path())
    model = factories.create_model(load_config(LOSS_S, default_config_path()),
                                   device="cpu")
    tr = factories.create_trainer(model, c, device="cpu")
    assert tr.cfg.saliency_sampling is True
    assert tr.cfg.n_ref_points == n_ref
    assert tr.cfg.saliency_mode == "loss"


# ---------------------------------------------------------------------------
# the lossS trajectory (configs/synthetic_sphere_lossS.yml)
# ---------------------------------------------------------------------------

def _run_loss_s(forced, monkeypatch):
    """8 iterations, warm_up_iters 3 and resample_every 3: warm-up 0-2,
    the resample at it 3 (before any statistics), the reference cloud
    seeded after step 3, and an inserting resample at it 6. Returns the
    per-step metrics, the warm-up length, the capacity, each package's
    insertions (children, child mask) and, forced, the saliency arrays
    after each projected step (`_run_projected`)."""
    from isopoints_tpu.models import levelset as j_levelset
    inserted = {"jax": [], "port": []}

    def recording(fn, key, to_np):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            inserted[key].append(tuple(to_np(a) for a in out))
            return out
        return wrapped
    monkeypatch.setattr(j_levelset, "insert_around_salient",
                        recording(j_insert, "jax", np.asarray))
    monkeypatch.setattr(levelset, "insert_around_salient",
                        recording(insert_around_salient, "port",
                                  lambda a: a.numpy()))
    rows, warm, m, jt, tt, saliency = _run_projected(
        forced, cfg_path=LOSS_S, n_iters=8, resample_every=3)
    assert len(inserted["jax"]) == len(inserted["port"]) == 1   # at it 6
    assert tt.saliency_state()["ref_stat_n"].max() == 5         # its 3-7
    return rows, warm, m, inserted, saliency


def test_loss_s_steps_match_jax_from_its_state(monkeypatch):
    """Each projected step started from the JAX state just before it
    (parameters, iso-point buffer, spacing and the four saliency arrays),
    the inserting resample at it 6 included: iso-point counts equal and
    every loss term within rtol 1e-4 + atol 1e-6, as
    test_projected_steps_match_jax_from_its_state; the children of the
    insertion: masks equal, points within 1e-5 (they are formed from the
    port's own uniform resample of JAX's buffer, whose Newton iterations
    differ from JAX's by float rounding).

    The saliency arrays each package's step leaves behind (the statistics
    the port builds from its own iso-points and colour residuals), after
    every projected step from the seeding at it 3 on: the reference mask
    and counts equal; the reference points equal once loaded from JAX
    (its 4-7: an update never moves them) and within 1e-5 at the seeding
    step, whose iso-points are the port's own resample of JAX's buffer,
    as the children's; the running means within rtol 1e-4 + atol 1e-6,
    the loss terms' bar, since they average the step's colour residuals
    (measured: 3.3e-5 at the seeding step, <= 2.1e-6 after it)."""
    rows, warm, _, inserted, saliency = _run_loss_s(True, monkeypatch)
    for it, (jm, tm) in enumerate(rows[warm:], start=warm):
        assert tm["n_iso"] == jm["n_iso"], it
        for k in LOSS_KEYS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"it {it} {k}")
    (jc, jcm), (c, cm) = inserted["jax"][0], inserted["port"][0]
    np.testing.assert_array_equal(cm, jcm)
    assert jcm.sum() > 0
    np.testing.assert_allclose(c[jcm], jc[jcm], atol=1e-5, rtol=0)
    assert [it for it, _, _ in saliency] == list(range(warm, len(rows)))
    for it, state, j_state in saliency:
        for k in ("ref_mask", "ref_stat_n"):
            np.testing.assert_array_equal(state[k], j_state[k],
                                          err_msg=f"it {it} {k}")
        np.testing.assert_allclose(state["ref_points"], j_state["ref_points"],
                                   atol=1e-5 if it == warm else 0, rtol=0,
                                   err_msg=f"it {it} ref_points")
        np.testing.assert_allclose(state["ref_stat_mean"],
                                   j_state["ref_stat_mean"], rtol=1e-4,
                                   atol=1e-6, err_msg=f"it {it} ref_stat_mean")


# the bars of test_projected_trajectory_tracks_jax (tests/test_torch_e2e.py)
def _within_projected_bars(jm, tm, m):
    return (abs(tm["n_iso"] - jm["n_iso"]) <= 0.05 * m
            and np.allclose(tm["loss"], jm["loss"], rtol=2e-2, atol=0)
            and all(np.allclose(tm[k], jm[k], rtol=0.1, atol=1e-3)
                    for k in LOSS_KEYS))


def _assert_free_running(rows, warm, m, second_resample):
    """Warm-up steps rtol 3e-4 + atol 1e-5 with equal counts; projected
    steps before `second_resample` within _within_projected_bars; from it
    on, the total within rtol 0.1 and counts within 15% of the capacity."""
    for it, (jm, tm) in enumerate(rows):
        if it < warm:
            assert tm["n_iso"] == jm["n_iso"], it
            for k in LOSS_KEYS:
                np.testing.assert_allclose(tm[k], jm[k], rtol=3e-4, atol=1e-5,
                                           err_msg=f"it {it} {k}")
        elif it < second_resample:
            assert _within_projected_bars(jm, tm, m), (it, jm, tm)
        else:
            assert abs(tm["n_iso"] - jm["n_iso"]) <= 0.15 * m, it
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=0.1,
                                       err_msg=f"it {it} loss")


def test_loss_s_trajectory_tracks_jax(monkeypatch):
    """The free-running lossS trajectory. Up to the second resample (its
    0-5), the bars of test_projected_trajectory_tracks_jax: warm-up steps
    rtol 3e-4 + atol 1e-5 with equal counts; projected steps the total
    within rtol 2e-2, each term within rtol 0.1 + atol 1e-3, counts within
    5% of the capacity. From the inserting resample at it 6 on, the two
    runs start from visibly different uniform buffers, drawn from clouds
    that the warm-up's ~1 ulp drift has already parted; the same happens
    without saliency, on the same schedule
    (test_second_resample_parts_the_runs_without_saliency). There only
    the total is held, within rtol 0.1, with counts within 15% of the
    capacity; step-level agreement through the inserting resample is
    test_loss_s_steps_match_jax_from_its_state's. Both packages insert
    children at it 6."""
    rows, warm, m, inserted, _ = _run_loss_s(False, monkeypatch)
    _assert_free_running(rows, warm, m, second_resample=6)
    assert inserted["jax"][0][1].sum() > 0 and inserted["port"][0][1].sum() > 0


def test_second_resample_parts_the_runs_without_saliency():
    """The witness for the loosened bars of test_loss_s_trajectory_tracks_jax
    from its second resample on: configs/synthetic_sphere_iso.yml (no
    saliency) on the same schedule (warm_up_iters 3, resample_every 3, 8
    iterations), free-running. Its 0-5 hold the projected-trajectory bars;
    at its 6-7, after the second uniform resample, at least one step
    leaves them (measured: 192 vs 214 iso-points of 256 at it 6, the total
    1.3214 vs 1.2206 and loss_occupied 0.1043 vs 0.0233 at it 7), while
    the loosened bars hold. Should the port ever stay within the old bars
    here, this test fails, and the lossS test's bars after it 6 must be
    tightened with it."""
    rows, warm, m, _, _, _ = _run_projected(False, n_iters=8, resample_every=3)
    _assert_free_running(rows, warm, m, second_resample=6)
    assert not all(_within_projected_bars(jm, tm, m) for jm, tm in rows[6:])
