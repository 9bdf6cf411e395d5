"""Port parity: the reference's main MVR configuration, configs/dtu_mvr.yml
(IGR 8x512 with positional encoding, the neural texture and the tuned trace
schedule), against the JAX package on the CPU.

Both packages read the config over configs/default.yaml and train on JAX's
DTU-layout torus directory (4 views at 24 px, per-view cameras). The width
is cut to hidden 64 and n_layers 5, which keeps what sets this field apart:
the skip at layer 4 (its input concatenated back and scaled by 1/√2), the 6
positional-encoding frequencies, weight norm and the final tanh. (The layer
before the skip has hidden − 39 outputs, 39 being the encoded input's
width, so hidden 32 cannot keep the skip.) Rays,
capacities and rasters are cut to 128 rays, 128 iso-points and 24 px;
the trace schedule (coarse_trace_iters 6, 13 sphere-tracing iterations,
fused backstep, coarse stall-on-cross, the coarse in-kernel sampler,
compaction after 6 and 9 at 0.8 / 0.55, sampler_fraction 0.5) is the
config's. The parameters come from JAX's init through `convert.py` with
weight norm kept; the draws are JAX's, rebuilt from its keys
(tests/test_torch_e2e.py).

Held here:
- the config composes through the factories (the port of
  tests/test_training.py `test_dtu_mvr_config_composes`), and
  isopoints_torch/configs/dtu_mvr_dir.yml differs from it only in data,
  the kernel rasters and `warm_up_iters`;
- the converted field: the positional-encoding columns of the input and
  skip layers zero in both (geometric init), the port's own init too; the
  SDF within 1e-6 (float32 sines of arguments up to 32) and its input
  gradient within 1e-6·max(1, |g|) of JAX's;
- the fall-through: no fused kernel exists for a field with positional
  encoding in either package, so `trace_sdf_fn` is the plain field and
  `trace_sdf_fn_coarse` None in both, and the config's coarse phase,
  stall-on-cross, coarse sampler and in-kernel sampler then change
  nothing: in each package the trace equals, bit for bit, the trace with
  those options off; the two packages' traces agree as
  tests/test_torch_trace_schedule.py holds them;
- two warm-up steps, the resample step and a projected step, each started
  from JAX's state just before it (parameters, Adam moments, iso-point
  buffer and spacing): iso-point counts equal, every loss term (the
  eikonal term goes through the embedder's input gradient) within rtol
  1e-4 + atol 1e-6 (the resample step: see its test), and the updated
  parameters within 1e-6 of JAX's (see its test for the few Adam moves
  apart).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.config import default_config_path as j_default
from isopoints_tpu.config import load_config as j_load
from isopoints_tpu.data import dataset as jds
from isopoints_tpu.data import synthetic as jsyn
from isopoints_tpu.factories import create_model as j_create_model
from isopoints_tpu.factories import create_trainer as j_create_trainer
from isopoints_tpu.models import raytracing as jrt
from isopoints_tpu.models.fields import sdf_and_grad as j_sdf_and_grad
from isopoints_tpu.rng import KeyChain
from isopoints_torch.config import default_config_path, load_config
from isopoints_torch.convert import params_from_jax
from isopoints_torch.data import dataset as tds
from isopoints_torch.data import synthetic as tsyn
from isopoints_torch.factories import create_dataset, create_model, create_trainer
from isopoints_torch.models import raytracing as trt
from isopoints_torch.models.fields import SDFField, sdf_and_grad
from isopoints_torch.training.trainer import AdamState
from test_torch_e2e import LOSS_KEYS, _projected_draws, _step_draws


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "dtu_mvr.yml")
DIR_CFG = os.path.join(ROOT, "isopoints_torch", "configs", "dtu_mvr_dir.yml")
S, WARM = 24, 2
# the schedule's options that need a fused field, off
PLAIN_SCHEDULE = dict(coarse_trace_iters=0, coarse_stall_on_cross=False,
                      sampler_coarse=False, sampler_in_kernel=False)


def _reduced(cfg, data_dir):
    cfg.data.data_dir = data_dir
    cfg.model.decoder_kwargs.update(hidden_size=64, n_layers=5)
    # the visible subset as wide as the cloud: the buffer keeps its shape
    # after the first projected step, and JAX compiles its step once
    cfg.model.combined_kwargs.update(max_iso_per_batch=128,
                                     n_points_per_cloud=128,
                                     visibility_image_size=S)
    cfg.renderer.raster_params.update(image_size=S, tile_size=8,
                                      max_points_per_tile=64)
    cfg.training.update(n_rays=128, n_eikonal_points=128, warm_up_iters=WARM,
                        scheduler_init_n_rays=128,
                        scheduler_init_n_points_dss=128)
    return cfg


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dtu_mvr") / "torus")
    jsyn.make_synthetic_dtu(jsyn.torus_sdf(), d, n_views=4, image_size=S)
    return d


def test_dtu_mvr_config_composes(tmp_path):
    """configs/dtu_mvr.yml builds the dataset, model and trainer through the
    port's factories against a DTU-layout directory and takes a step (the
    JAX test's shrink: hidden 32, 2 layers)."""
    out = str(tmp_path / "dtu")
    tsyn.make_synthetic_dtu(tsyn.sphere_sdf(0.5), out, n_views=2,
                            image_size=24, device="cpu")
    cfg = load_config(CFG, default_config_path())
    cfg.data.data_dir = out
    cfg.model.decoder_kwargs.update(hidden_size=32, n_layers=2)
    cfg.model.combined_kwargs.update(max_iso_per_batch=64,
                                     n_points_per_cloud=128,
                                     visibility_image_size=24)
    cfg.renderer.raster_params.update(image_size=24, tile_size=8,
                                      max_points_per_tile=64)
    cfg.training.update(n_rays=32, n_eikonal_points=32)
    ds = create_dataset(cfg, device="cpu")
    assert isinstance(ds, tds.DTUDataset)
    model = create_model(cfg, device="cpu")
    assert isinstance(model.decoder, SDFField)
    assert model.decoder.num_frequencies == 6 and model.texture is not None
    trainer = create_trainer(model, cfg, device="cpu")
    state = trainer.init_state()
    item = ds[0]
    state, metrics = trainer.train_step(
        state, torch.from_numpy(item["img.rgb"])[None],
        torch.from_numpy(item["img.mask"])[None],
        ds.camera([0], (24, 24), device="cpu"))
    assert np.isfinite(metrics["loss"]) and state.it == 1


def test_dir_config_inherits_dtu_mvr():
    """dtu_mvr_dir.yml is configs/dtu_mvr.yml but for the data directory,
    the kernel rasters and warm_up_iters (the one schedule cut)."""
    got = load_config(DIR_CFG, default_config_path()).to_dict()
    ref = j_load(CFG, j_default()).to_dict()
    assert got["data"]["data_dir"] == "out/torch_data_dtu_torus"
    assert got["renderer"]["raster_params"].pop("use_pallas") is True
    assert got["training"]["warm_up_iters"] == 40
    for c in (got, ref):
        c.pop("inherit_from", None)
        c["data"].pop("data_dir")
        c["training"].pop("warm_up_iters")
    assert got == ref
    assert ref["model"]["decoder_kwargs"] == {"hidden_size": 512, "n_layers": 8}


def _to_port(params):
    return params_from_jax(jax.tree.map(np.asarray, dict(params)),
                           keep_weight_norm=True)


def _adam_to_port(opt_state):
    """The port's AdamState from the optax chain's ScaleByAdamState."""
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")][0]
    return AdamState(int(adam.count), _to_port(adam.mu), _to_port(adam.nu))


@pytest.fixture(scope="module")
def models(data_dir):
    """Both configs, JAX's trainer and initial state, and the port's model
    on JAX's initial parameters."""
    jcfg = _reduced(j_load(CFG, j_default()), data_dir)
    tcfg = _reduced(load_config(CFG, default_config_path()), data_dir)
    j_trainer = j_create_trainer(j_create_model(jcfg), jcfg, seed=0)
    j_state = j_trainer.init_state()
    tmodel = create_model(tcfg, device="cpu")
    tmodel.load_state_dict(_to_port(j_state.params))
    return tcfg, j_trainer, j_state, tmodel


def test_positional_columns_carried_exactly(models):
    """Geometric init zeroes the encoding's columns of the input layer and
    the skip layer's encoding tail (fields.py:232-237): zero in JAX's init,
    in its conversion and in the port's own init."""
    _, j_trainer, j_state, tmodel = models
    jmodel, params = j_trainer.model, j_state.params
    own = SDFField(hidden_size=64, n_layers=5, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    d0 = jmodel.decoder.dims[0]
    assert d0 == 3 + 3 * 2 * 6
    for layer, cols in ((0, slice(3, None)), (4, slice(-(d0 - 3), None))):
        v_j = np.asarray(params["decoder"]["layers"][layer]["v"])
        v_t = tmodel.decoder.layers[layer].v.detach().numpy()
        assert np.array_equal(v_t, v_j)
        assert not v_j[:, cols].any() and v_j[:, :3].any()
        assert not own.layers[layer].v.detach()[:, cols].any()


def test_field_and_input_gradient_match_jax(models):
    _, j_trainer, j_state, tmodel = models
    jmodel, params = j_trainer.model, j_state.params
    x = np.random.RandomState(3).uniform(-1, 1, (2000, 3)).astype(np.float32)
    f_j, g_j = j_sdf_and_grad(lambda p: jmodel.decoder.sdf(params["decoder"], p),
                              jnp.asarray(x))
    f_t, g_t = sdf_and_grad(tmodel.sdf_fn(), torch.from_numpy(x))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j), rtol=0,
                               atol=1e-6)
    err = np.abs(g_t.detach().numpy() - g_j) / np.maximum(1.0, np.abs(g_j))
    assert err.max() <= 1e-6, err.max()


def _rays(jcam, tcam, n=1024, seed=5):
    """`n` rays of view 0 through uniformly drawn pixels, both packages."""
    px = np.random.RandomState(seed).uniform(-1, 1, (1, n, 2)).astype(np.float32)
    cam_j, d_j = jcam.ndc_to_rays(jnp.asarray(px))
    cam_t, d_t = tcam.ndc_to_rays(torch.from_numpy(px))
    return (np.asarray(jcam.camera_center())[:, None], np.asarray(d_j),
            tcam.camera_center()[:, None], d_t)


def test_schedule_falls_through_alike(models, data_dir):
    """Both packages trace the plain field under the config's schedule, and
    its fused-only options are inert in both."""
    _, j_trainer, j_state, tmodel = models
    jmodel, params = j_trainer.model, j_state.params
    j_f, t_f = jmodel.trace_sdf_fn(params), tmodel.trace_sdf_fn()
    for f in (j_f, t_f):
        assert not any(hasattr(f, a) for a in ("sdf_and_grad", "fused_ray_sampler",
                                               "fused_trace_stepper"))
    assert jmodel.trace_sdf_fn_coarse(params) is None
    assert tmodel.trace_sdf_fn_coarse() is None
    j_cfg, t_cfg = jmodel.raytrace_cfg, tmodel.raytrace_cfg
    for c in (j_cfg, t_cfg):
        assert (c.coarse_trace_iters, c.sphere_tracing_iters) == (6, 13)
        assert c.coarse_stall_on_cross and c.sampler_coarse and c.sampler_in_kernel
        assert c.fused_backstep and tuple(c.trace_compact_after) == (6, 9)
    j_ds, t_ds = jds.DTUDataset(data_dir), tds.DTUDataset(data_dir)
    cam_j, d_j, cam_t, d_t = _rays(j_ds.camera([0], (S, S)),
                                   t_ds.camera([0], (S, S), device="cpu"))
    gt = np.ones(d_j.shape[:2], bool)
    j_trace = {}
    for name, c in (("config", j_cfg), ("plain", dataclasses.replace(
            j_cfg, **PLAIN_SCHEDULE))):
        j_trace[name] = jax.jit(lambda cc, dd, g, c=c: jrt.ray_trace(
            j_f, cc, dd, g, jax.random.key(1), c, training=False,
            sdf_fn_coarse=jmodel.trace_sdf_fn_coarse(params)))(
                jnp.asarray(cam_j), jnp.asarray(d_j), jnp.asarray(gt))
    t_trace = {}
    with torch.no_grad():
        for name, c in (("config", t_cfg), ("plain", dataclasses.replace(
                t_cfg, **PLAIN_SCHEDULE))):
            t_trace[name] = trt.ray_trace(t_f, cam_t, d_t, torch.from_numpy(gt),
                                          None, c, training=False,
                                          sdf_fn_coarse=tmodel.trace_sdf_fn_coarse())
    for a, b in zip(t_trace["config"], t_trace["plain"]):
        assert torch.equal(a, b)
    for a, b in zip(j_trace["config"], j_trace["plain"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    hit_j = np.asarray(j_trace["config"].network_object_mask)
    hit_t = t_trace["config"].network_object_mask.numpy()
    smp_j = np.asarray(j_trace["config"].sampler_mask)
    smp_t = t_trace["config"].sampler_mask.numpy()
    n = hit_j.size
    assert 0 < hit_j.sum() < n
    assert (hit_j != hit_t).sum() <= 0.01 * n and (smp_j != smp_t).sum() <= 0.01 * n
    same = (hit_j == hit_t) & (smp_j == smp_t)
    close = np.abs(t_trace["config"].dists.numpy()
                   - np.asarray(j_trace["config"].dists)) <= 1e-4
    assert close[same].mean() >= 0.98


@pytest.fixture(scope="module")
def steps(models, data_dir):
    """Its 0-3 of both trainers (warm-up at 0 and 1, the resample and the
    first projected step at 2, a projected step at 3), the port's each
    started from JAX's state before it. Returns, per step, (it, JAX's
    metrics, the port's, JAX's parameters after, the port's)."""
    tcfg, j_trainer, j_state, _ = models
    j_ds, t_ds = jds.DTUDataset(data_dir), tds.DTUDataset(data_dir)
    images = np.stack([t_ds[i]["img.rgb"] for i in range(len(t_ds))])
    masks = np.stack([t_ds[i]["img.mask"] for i in range(len(t_ds))])
    model = create_model(tcfg, device="cpu")
    trainer = create_trainer(model, tcfg, seed=0, device="cpu")
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    t_state = trainer.init_state()
    keys = KeyChain(0)
    keys.next(), keys.next()                       # init_state's two keys
    n_rays = trainer.scheduler.at(0)["n_rays"]
    m = model.ccfg.max_iso_per_batch
    rows = []
    for it in range(4):
        idx = np.random.RandomState(it).choice(len(t_ds), size=2, replace=False)
        jcam, tcam = j_ds.camera(idx, (S, S)), t_ds.camera(idx, (S, S), device="cpu")
        img, mask = images[idx], masks[idx]
        model.load_state_dict(_to_port(j_state.params))
        t_state = t_state._replace(opt_state=_adam_to_port(j_state.opt_state),
                                   points=t(j_state.points),
                                   points_mask=t(j_state.points_mask),
                                   spacing=t(j_state.spacing), it=it)
        resample_u = None
        if it == WARM:                             # the resample's own key
            rk = keys.next()
            if t_state.points.shape[1] > trainer.scheduler.at(it)["n_points_dss"]:
                resample_u = t(jax.random.uniform(jax.random.split(rk)[1],
                                                  t_state.points_mask.shape))
        if it < WARM:
            draws = _step_draws(keys.next(), n_rays, trainer.cfg.n_eikonal_points,
                                model.raytrace_cfg.n_steps, (S, S))
        else:
            width = (trainer.scheduler.at(it)["n_points_dss"] if it == WARM
                     else t_state.points.shape[1])
            draws = _projected_draws(keys.next(), n_rays,
                                     trainer.cfg.n_eikonal_points,
                                     model.raytrace_cfg.n_steps, (S, S), width, m)
        draws = draws._replace(resample_u=resample_u)
        j_state, jm = j_trainer.train_step(j_state, jnp.asarray(img),
                                           jnp.asarray(mask), jcam)
        t_state, tm = trainer.train_step(t_state, torch.from_numpy(img),
                                         torch.from_numpy(mask), tcam, draws=draws)
        rows.append((it, jm, tm, _to_port(j_state.params),
                     {k: v.detach().clone() for k, v in model.state_dict().items()}))
    return rows


def test_steps_match_jax_from_its_state(steps):
    """The warm-up steps (its 0, 1) and the projected step at it 3: counts
    equal, every term within rtol 1e-4 + atol 1e-6 (measured <= 1e-6
    relative). The resample step (it 2) resamples JAX's buffer with the
    port's own Newton projection, whose stop at |sdf| <= tolerance can
    leave a point at another spot of the level set (as in
    tests/test_torch_dataset.py): its counts within 1% of the capacity and
    its terms within rtol 1e-2 (measured: equal counts, the RGB term 0.43%
    apart, the others within 1e-6)."""
    for it, jm, tm, _, _ in steps:
        assert jm["n_iso"] > 0 and tm["overflow_trace"] == jm["overflow_trace"] == 0
        if it == WARM:
            assert abs(tm["n_iso"] - jm["n_iso"]) <= 0.01 * 128, it
            for k in LOSS_KEYS:
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-2,
                                           err_msg=f"it {it} {k}")
            continue
        assert tm["n_iso"] == jm["n_iso"], it
        for k in LOSS_KEYS:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"it {it} {k}")


def test_updated_parameters_match_jax(steps):
    """The clip + Adam update from the same state: after each step at least
    99.9% of every parameter's entries within 1e-6 of JAX's, all within
    2e-4. Adam moves a weight by lr·m̂/(√v̂ + 1e-8), about ±lr = 1e-4 where
    |g| is near 1e-8 in the first step, so float rounding of such a
    gradient can move the weight anywhere in ±lr (measured: 1 entry of
    4096 at 6.8e-6 after it 0, the rest within 5e-7). After the resample
    step, whose iso-points differ (see above), only the 2e-4 holds
    (measured 1.15e-4, the texture's first layer)."""
    for it, _, _, j_params, t_params in steps:
        assert sorted(j_params) == sorted(t_params)
        for k, v in t_params.items():
            d = np.abs(v.numpy() - j_params[k].numpy())
            assert d.max() <= 2e-4, (it, k, d.max())
            if it != WARM:
                assert (d > 1e-6).mean() <= 1e-3, (it, k, d.max())
