"""Port parity: isopoints_torch/configs/igr_mvr_dir.yml, the network
published with IGR (8x512, skip at 4, softplus β = 100, weight norm, final
tanh, raw xyz) under configs/dtu_mvr.yml's tuned trace schedule, against
the JAX package on the CPU.

Without positional encoding both packages have a fused kernel for the
field, so both trace on it: the bf16 coarse phase, the f32 fine stages and
the coarse in-kernel sampler (JAX's Pallas kernels in interpret mode; the
port's kernels' plain versions, which tests/test_torch_igr.py holds
against them and chip_smoke.py's phase 20 holds the kernels against on the
card). The width is cut to hidden 320 and n_layers 5, which keeps the skip
at layer 4 and pads on the card to the 384-wide instance; rays,
capacities and rasters as tests/test_torch_dtu_mvr.py cuts them (128 rays,
128 iso-points, 24 px, JAX's DTU-layout torus of 4 views).

Held here:
- igr_mvr_dir.yml differs from configs/dtu_mvr.yml only in the data, the
  kernel rasters, `warm_up_iters` and `num_frequencies`;
- both packages' `trace_sdf_fn` is the fused callable (value, gradient,
  sampler and march), and `trace_sdf_fn_coarse` is not None;
- a warm-up step, the resample step and a projected step, each started
  from JAX's state just before it, at tests/test_torch_dtu_mvr.py's bars:
  counts equal and every loss term within rtol 1e-4 + atol 1e-6, the
  resample step's counts within 1% of the capacity and its terms within
  rtol 1e-2; the updated parameters within 2e-4 of JAX's, and past the
  resample step 99.9% of every parameter's entries within 1e-6 (at the
  first step, of the entries whose gradient exceeds 1e-6: see
  `test_updated_parameters_match_jax`). JAX traces its fine field at
  `highest` here (`_jax_fused_highest`): the port's f32 mode is float32,
  JAX's default `f32x3` a TPU mode about 2^-16 off.
"""

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
from isopoints_tpu.ops import pallas_mlp
from isopoints_tpu.rng import KeyChain
from isopoints_torch.config import default_config_path, load_config
from isopoints_torch.data import dataset as tds
from isopoints_torch.factories import create_model, create_trainer
from isopoints_torch.ops import fused_mlp
from test_torch_dtu_mvr import _adam_to_port, _to_port
from test_torch_e2e import LOSS_KEYS, _projected_draws, _step_draws


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "dtu_mvr.yml")
IGR_CFG = os.path.join(ROOT, "isopoints_torch", "configs", "igr_mvr_dir.yml")
S, WARM = 24, 1


def _reduced(cfg, data_dir):
    cfg.data.data_dir = data_dir
    cfg.model.decoder_kwargs.update(hidden_size=320, n_layers=5, num_frequencies=0)
    cfg.model.combined_kwargs.update(max_iso_per_batch=128,
                                     n_points_per_cloud=128,
                                     visibility_image_size=S)
    cfg.renderer.raster_params.update(image_size=S, tile_size=8,
                                      max_points_per_tile=64)
    cfg.training.update(n_rays=128, n_eikonal_points=128, warm_up_iters=WARM,
                        scheduler_init_n_rays=128,
                        scheduler_init_n_points_dss=128)
    return cfg


def test_igr_config_differs_from_dtu_mvr_only_in_data_rasters_warmup_encoding():
    got = load_config(IGR_CFG, default_config_path()).to_dict()
    ref = j_load(CFG, j_default()).to_dict()
    assert got["data"]["data_dir"] == "out/torch_data_dtu_torus"
    assert got["renderer"]["raster_params"].pop("use_pallas") is True
    assert got["training"]["warm_up_iters"] == 40
    assert got["model"]["decoder_kwargs"].pop("num_frequencies") == 0
    for c in (got, ref):
        c.pop("inherit_from", None)
        c["data"].pop("data_dir")
        c["training"].pop("warm_up_iters")
    assert got == ref
    assert got["model"]["decoder_kwargs"] == {"hidden_size": 512, "n_layers": 8}
    assert got["model"]["implicit_kwargs"]["use_fused_mlp"] is True


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("igr_mvr") / "torus")
    jsyn.make_synthetic_dtu(jsyn.torus_sdf(), d, n_views=4, image_size=S)
    return d


@pytest.fixture(scope="module")
def models(data_dir):
    """Both configs (the port's read from igr_mvr_dir.yml), JAX's trainer
    and initial state, and the port's model on JAX's initial parameters."""
    jcfg = j_load(CFG, j_default())
    jcfg.model.decoder_kwargs.update(num_frequencies=0)
    jcfg = _reduced(jcfg, data_dir)
    tcfg = _reduced(load_config(IGR_CFG, default_config_path()), data_dir)
    j_trainer = j_create_trainer(j_create_model(jcfg), jcfg, seed=0)
    j_state = j_trainer.init_state()
    tmodel = create_model(tcfg, device="cpu")
    tmodel.load_state_dict(_to_port(j_state.params))
    return tcfg, j_trainer, j_state, tmodel


def test_both_trace_on_the_fused_field(models):
    _, j_trainer, j_state, tmodel = models
    jmodel, params = j_trainer.model, j_state.params
    assert jmodel.decoder.num_frequencies == tmodel.decoder.num_frequencies == 0
    assert tuple(tmodel.decoder.skip_in) == (4,)
    j_f, t_f = jmodel.trace_sdf_fn(params), tmodel.trace_sdf_fn()
    for f in (j_f, t_f):
        assert all(hasattr(f, a) for a in ("sdf_and_grad", "fused_ray_sampler",
                                           "fused_trace_stepper"))
    assert isinstance(t_f, fused_mlp.FusedIgrSDF) and t_f.precision == "f32"
    assert jmodel.trace_sdf_fn_coarse(params) is not None
    t_c = tmodel.trace_sdf_fn_coarse()
    assert isinstance(t_c, fused_mlp.FusedIgrSDF) and t_c.precision == "bf16"
    # on the card: padded to the 384-wide instance, the point's columns last
    assert t_f.pack.arch_args()[:3] == (384, 4, 1 << 4)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (200, 3))
                         .astype(np.float32))
    v_j = np.asarray(j_f(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(t_f(x).numpy(), v_j, atol=2e-5, rtol=0)


def _jax_fused_highest(field, params, interpret=None, bf16=None, precision=None):
    """JAX's fine trace callable in its `highest` mode, the f32 the port's
    f32 kernels compute (3xTF32, within ~2^-22 of each product; the plain
    versions exact float32), as tests/test_torch_trace_schedule.py traces.
    The config's default, `f32x3`, splits each operand into two bf16
    halves, ~2^-16 of a product: the traced points then move by ~1e-5, and
    the steps' terms by up to ~1%."""
    if precision is None and not bf16:
        precision = "highest"
    return _JAX_MAKE_FUSED(field, params, interpret, bf16, precision)


_JAX_MAKE_FUSED = pallas_mlp.make_fused_sdf_fn


@pytest.fixture(scope="module")
def steps(models, data_dir):
    """Its 0-2 of both trainers (a warm-up step at 0, the resample and the
    first projected step at 1, a projected step at 2), the port's each
    started from JAX's state before it, JAX tracing its fine field at
    `highest` (`_jax_fused_highest`). Returns, per step, (it, JAX's
    metrics, the port's, JAX's parameters after, the port's, JAX's Adam
    first moments)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_mlp, "make_fused_sdf_fn", _jax_fused_highest)
        return _run_steps(models, data_dir)


def _run_steps(models, data_dir):
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
    for it in range(3):
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
                     {k: v.detach().clone() for k, v in model.state_dict().items()},
                     _adam_to_port(j_state.opt_state).mu))
    return rows


def test_steps_match_jax_from_its_state(steps):
    """tests/test_torch_dtu_mvr.py's bars (see its test of the same name)."""
    for it, jm, tm, *_ in steps:
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
    """tests/test_torch_dtu_mvr.py's bars (see its test of the same name):
    every entry within 2e-4 (= 2 lr) of JAX's, and past the resample step
    99.9% of every parameter's entries within 1e-6, at the first step
    counting the entries whose gradient exceeds 1e-6. Adam's first step
    moves a weight by lr·g/(|g| + 1e-8), and the packages' gradients here
    differ by up to 2e-3 of the largest (a traced ray whose outcome sits
    within round-off of a threshold flips): at 320 wide the first hidden
    layer has ~170 of 102,400 weights whose gradient (median 1.4e-7, 800x
    below the layer's median) is that small, and their steps part by up to
    2e-4; every weight with a gradient above 1e-6 but 4 stays within 1e-6."""
    for it, _, _, j_params, t_params, j_mu in steps:
        assert sorted(j_params) == sorted(t_params)
        for k, v in t_params.items():
            d = np.abs(v.numpy() - j_params[k].numpy())
            assert d.max() <= 2e-4, (it, k, d.max())
            if it == WARM:
                continue
            far = d > 1e-6
            if it == 0 and k in j_mu:       # Adam's first moment: 0.1 g
                far &= np.abs(j_mu[k].numpy()) * 10 > 1e-6
            assert far.mean() <= 1e-3, (it, k, d.max(), far.sum())
