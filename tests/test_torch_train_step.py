"""Port parity: one warm-up MVR training step against the JAX package.

Both packages start from the same parameters (JAX init, converted) and
the same random numbers: the test rebuilds the JAX step's draws from its
key exactly as isopoints_tpu splits it (parallel/sharding.py:98-103 for
the pixels, training/trainer.py:99,144 for the eikonal points,
models/raytracing.py:1010,1055-1060 for the min-SDF step fractions) and
hands them to the port. The port runs the slice's config (fused MLP and
in-kernel sampler, which on the CPU are their plain twins); the JAX side
runs the plain field, which its own tests hold equal to its kernels.

The projected step (from `warm_up_iters` on) is held the same way, on an
iso-point buffer Newton-projected by the JAX package and the projected
forward's draws rebuilt from the JAX key (models/combined.py:116, 278).

Tolerances: loss terms rtol 1e-4 (float32 sums over a few hundred rays in
two summation orders); pre-clip gradients, divided by their global norm,
rtol 1e-3, atol 1e-6 (they pass through the double backward of the
eikonal and the 64th-power specular term); the clip + Adam update rule,
fed the same gradients, atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.models.combined import CombinedModel as JCombined
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.implicit import ImplicitConfig as JImplicitConfig
from isopoints_tpu.ops.images import sample_random_pixels as j_pixels
from isopoints_tpu.training.trainer import compute_loss as j_compute_loss
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.camera import cameras_from_matrices
from isopoints_torch.data.synthetic import make_synthetic_mvr, sphere_sdf
from isopoints_torch.models.combined import CombinedModel, ProjectedDraws
from isopoints_torch.models.fields import SirenField
from isopoints_torch.models.implicit import ImplicitConfig
from isopoints_torch.ops import fused_mlp, fused_sampler
from isopoints_torch.training.trainer import (AdamState, MVRTrainer, StepDraws,
                                              TrainerConfig, clip_and_adam,
                                              compute_loss)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_RAYS, N_EIK, N_STEPS = 128, 128, 100
HP = {"lambda_rgb": 1.0, "lambda_freespace": 1.0, "lambda_occupied": 1.0,
      "sdf_alpha": 10.0, "lambda_eikonal": 0.01}
LOSS_KEYS = ("loss", "loss_rgb", "loss_freespace", "loss_occupied",
             "loss_eikonal")


@pytest.fixture(scope="module")
def world():
    data = make_synthetic_mvr(sphere_sdf(), n_views=4, image_size=16,
                              device="cpu")
    idx = np.array([1, 3])
    img, mask = data["img.rgb"][idx], data["img.mask"][idx]
    mats = data["camera_mat"][idx]
    jcam = JCam.create(R=mats[:, :3, :3], T=mats[:, 3, :3],
                       focal_length=data["focal_length"],
                       principal_point=data["principal_point"])
    tcam = cameras_from_matrices(mats, data["focal_length"],
                                 data["principal_point"], device="cpu")
    jmodel = JCombined(JSiren(hidden_size=64, n_layers=2), cfg=JImplicitConfig())
    params = jmodel.init(jax.random.key(0))
    tmodel = CombinedModel(
        SirenField(hidden_size=64, n_layers=2, device="cpu"),
        ImplicitConfig(use_fused_mlp=True,
                       raytrace={"sampler_in_kernel": True}))
    tmodel.load_state_dict(params_from_jax(
        {"decoder": jax.tree.map(np.asarray, params["decoder"])}))
    return dict(img=img, mask=mask, jcam=jcam, tcam=tcam, jmodel=jmodel,
                params=params, tmodel=tmodel)


def jax_step_draws(key, batch, image_size):
    """The JAX warm-up step's random numbers, split as isopoints_tpu does."""
    k_pix, k_loss = jax.random.split(key)                    # sharding.py:98
    pixels = j_pixels(k_pix, N_RAYS, image_size, batch_size=batch)
    k1, k2, _ = jax.random.split(k_loss, 3)                  # trainer.py:99
    eik = jax.random.uniform(k2, (1, N_EIK, 3), minval=-1.0, maxval=1.0)
    _, k_min = jax.random.split(k1)                          # raytracing.py:1010
    u = jax.random.uniform(k_min, (N_STEPS,))                # raytracing.py:960
    draws = StepDraws(*(torch.from_numpy(np.array(a)) for a in (pixels, eik, u)))
    return pixels, k_loss, draws


def _jax_loss_and_grads(w, pixels, k_loss):
    def loss_fn(p):
        total, (metrics, *_rest) = j_compute_loss(
            w["jmodel"], p, None, None, pixels, jnp.asarray(w["img"]),
            jnp.asarray(w["mask"]), w["jcam"], k_loss,
            {k: jnp.float32(v) for k, v in HP.items()}, project=False,
            n_eikonal_points=N_EIK)
        return total, metrics
    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(w["params"])
    return metrics, grads


@pytest.fixture(scope="module")
def step_pair(world):
    pixels, k_loss, draws = jax_step_draws(jax.random.key(11), 2, (16, 16))
    j_metrics, j_grads = _jax_loss_and_grads(world, pixels, k_loss)
    tmodel = world["tmodel"]
    total, t_metrics, _, _, _ = compute_loss(
        tmodel, None, None, draws.pixels, torch.from_numpy(world["img"]),
        torch.from_numpy(world["mask"]), world["tcam"], draws.eikonal,
        draws.u_minsdf, HP, project=False)
    names = [n for n, _ in tmodel.named_parameters()]
    t_grads = dict(zip(names, torch.autograd.grad(total,
                                                  list(tmodel.parameters()))))
    return j_metrics, j_grads, t_metrics, t_grads


def test_loss_terms_match(step_pair):
    j_metrics, _, t_metrics, _ = step_pair
    assert float(j_metrics["n_iso"]) > 0
    assert float(t_metrics["n_iso"]) == float(j_metrics["n_iso"])
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(t_metrics[k].detach()),
                                   float(j_metrics[k]),
                                   rtol=1e-4, err_msg=k)


def test_preclip_grads_match(step_pair):
    """Gradients in units of their global norm, the unit the clip works
    in: float32 double-backward noise is ~1e-5 of the largest entry on
    either side (each package measured against a float64 run of the
    port), so an absolute 1e-6 only holds relative to the gradient's
    scale."""
    _, j_grads, _, t_grads = step_pair
    leaves = jax.tree.leaves(j_grads)
    norm = float(np.sqrt(sum(np.sum(np.asarray(a, np.float64) ** 2)
                             for a in leaves)))
    assert norm > 0
    for i, lp in enumerate(j_grads["decoder"]["layers"]):
        for leaf, name in (("w", "weight"), ("b", "bias")):
            np.testing.assert_allclose(
                t_grads[f"decoder.layers.{i}.{name}"].numpy() / norm,
                np.asarray(lp[leaf]) / norm, rtol=1e-3, atol=1e-6,
                err_msg=f"layer {i} {leaf}")


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_update_rule_matches_optax(world, scale):
    """clip_by_global_norm(1) + adam(1e-4, 0.9, 0.99) over two steps, on
    gradients both above (scale 1) and below (1e-3) the clip norm."""
    rng = np.random.RandomState(4)
    params = jax.tree.map(np.asarray, world["params"]["decoder"])
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * scale)
                          .astype(np.float32), params) for _ in range(2)]
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(1e-4, b1=0.9, b2=0.99))
    j_params, j_state = params, opt.init(params)
    t_params = {k: v.clone() for k, v in
                params_from_jax({"decoder": params}).items()}
    t_state = AdamState(0, {k: torch.zeros_like(v) for k, v in t_params.items()},
                        {k: torch.zeros_like(v) for k, v in t_params.items()})
    for g in grads:
        upd, j_state = opt.update(g, j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        t_state = clip_and_adam(t_params, params_from_jax({"decoder": g}),
                                t_state, 1e-4, 1.0)
    ref = params_from_jax({"decoder": jax.tree.map(np.asarray, j_params)})
    for k, v in t_params.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-7,
                                   rtol=0, err_msg=k)


def test_three_warmup_steps_stay_finite(world):
    model = CombinedModel(
        SirenField(hidden_size=64, n_layers=2,
                   generator=torch.Generator().manual_seed(0), device="cpu"),
        ImplicitConfig(use_fused_mlp=True, raytrace={"sampler_in_kernel": True}))
    trainer = MVRTrainer(model, TrainerConfig(n_rays=N_RAYS,
                                              n_eikonal_points=N_EIK),
                         seed=0, device="cpu")
    state = trainer.init_state()
    img = torch.from_numpy(world["img"])
    mask = torch.from_numpy(world["mask"])
    before = [p.detach().clone() for p in model.parameters()]
    for _ in range(3):
        state, metrics = trainer.train_step(state, img, mask, world["tcam"])
        assert all(np.isfinite(metrics[k]) for k in LOSS_KEYS)
    assert state.it == 3 and state.opt_state.count == 3
    assert trainer.check_state()
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    # the CPU path takes the plain twins: no kernel launched
    assert fused_mlp.KERNEL.launches == fused_sampler.KERNEL.launches == 0


# ---------------------------------------------------------------------------
# The projected step: the same comparison from `warm_up_iters` on
# ---------------------------------------------------------------------------

def jax_projected_draws(k_loss, n_points, m, batch=2):
    """The projected step's draws from compute_loss's key, split as
    isopoints_tpu does (trainer.py:99-103,144; combined.py:116,278)."""
    k1, k2, k3 = jax.random.split(k_loss, 3)
    ray_u = jax.random.uniform(k3, (batch, N_RAYS))
    eik = jax.random.uniform(k2, (1, N_EIK, 3), minval=-1.0, maxval=1.0)
    k_sel, k_off = jax.random.split(jax.random.split(k1)[0])
    scores = jax.random.uniform(k_sel, (1, n_points))
    offset = jax.random.uniform(k_off, (1, m, 3))
    t = lambda a: torch.from_numpy(np.array(a))
    return t(eik), ProjectedDraws(t(scores), t(offset), t(ray_u))


@pytest.fixture(scope="module")
def projected_pair():
    from test_torch_combined import (CCFG, iso_buffer, projected_models,
                                     views)
    jmodel, params, tmodel = projected_models(seed=2)
    img, mask, jcam, tcam = views(idx=(0, 2))
    pts, pmask = iso_buffer(jmodel, params, seed=4)
    key = jax.random.key(21)
    k_pix, k_loss = jax.random.split(key)
    pixels = j_pixels(k_pix, N_RAYS, img.shape[1:3], batch_size=2)

    def loss_fn(p):
        total, (metrics, new_pts, new_mask, _) = j_compute_loss(
            jmodel, p, jnp.asarray(pts), jnp.asarray(pmask), pixels,
            jnp.asarray(img), jnp.asarray(mask), jcam, k_loss,
            {k: jnp.float32(v) for k, v in HP.items()}, project=True,
            n_eikonal_points=N_EIK)
        return total, (metrics, new_pts, new_mask)
    (_, (j_metrics, j_pts, j_mask)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    eik, draws = jax_projected_draws(k_loss, pts.shape[1],
                                     CCFG["max_iso_per_batch"])
    total, t_metrics, t_pts, t_mask, _ = compute_loss(
        tmodel, torch.from_numpy(pts), torch.from_numpy(pmask),
        torch.from_numpy(np.array(pixels)), torch.from_numpy(img),
        torch.from_numpy(mask), tcam, eik, None, HP, project=True,
        proj_draws=draws)
    names = [n for n, _ in tmodel.named_parameters()]
    t_grads = dict(zip(names, torch.autograd.grad(total,
                                                  list(tmodel.parameters()))))
    return (j_metrics, j_grads, np.asarray(j_mask), t_metrics, t_grads,
            t_mask.numpy())


def test_projected_loss_terms_match(projected_pair):
    """The warm-up step's rtol 1e-4 holds here: at this size the visible
    iso-point sets come out equal. Counts may differ by 1% of the capacity
    (a Newton convergence within round-off of the tolerance)."""
    j_metrics, _, j_mask, t_metrics, _, t_mask = projected_pair
    m = j_mask.size
    assert float(j_metrics["n_iso"]) > 0
    assert abs(float(t_metrics["n_iso"]) - float(j_metrics["n_iso"])) <= 0.01 * m
    assert abs(int(t_mask.sum()) - int(j_mask.sum())) <= 0.01 * m
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(t_metrics[k].detach()),
                                   float(j_metrics[k]), rtol=1e-4, err_msg=k)
    assert float(t_metrics["loss_freespace"].detach()) > 0
    assert float(t_metrics["loss_occupied"].detach()) > 0


def test_projected_preclip_grads_match(projected_pair):
    """The warm-up step's rule: rtol 1e-3, atol 1e-6 in units of the
    gradient's global norm."""
    _, j_grads, _, _, t_grads, _ = projected_pair
    leaves = jax.tree.leaves(j_grads)
    norm = float(np.sqrt(sum(np.sum(np.asarray(a, np.float64) ** 2)
                             for a in leaves)))
    assert norm > 0
    for i, lp in enumerate(j_grads["decoder"]["layers"]):
        for leaf, name in (("w", "weight"), ("b", "bias")):
            np.testing.assert_allclose(
                t_grads[f"decoder.layers.{i}.{name}"].numpy() / norm,
                np.asarray(lp[leaf]) / norm, rtol=1e-3, atol=1e-6,
                err_msg=f"layer {i} {leaf}")
