"""Port parity: the neural texture (`RenderingNetwork`, `neural_texture`,
`PerspectiveCamera.view_direction`) and the combined model's warm-up and
projected steps with it, against the JAX package on the CPU; the factory
on isopoints_torch/configs/mvr_uni_siren.yml.

The texture net is 2×32 (weight-normalised, 4 view frequencies, c_dim 0),
from the JAX init, converted. Tolerances: the net's colours atol 1e-6 and
its gradients (to the inputs and to v, g, b) atol 1e-6 relative to their
largest entry: float32 sums of a few hundred products in two orders, then
tanh. The steps run the model of tests/test_torch_train_step.py and
tests/test_torch_combined.py (SIREN 2×64, the synthetic sphere) with the
neural texture: loss terms rtol 1e-4, and pre-clip gradients, decoder and
texture, rtol 1e-3, atol 1e-6 in units of the gradient's global norm, the
rules those files hold the Phong steps to. The texture's gradients must be
non-zero (the colours reach the loss through the RGB term).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.models.combined import CombinedConfig as JCombinedConfig
from isopoints_tpu.models.combined import CombinedModel as JCombined
from isopoints_tpu.models.fields import RenderingNetwork as JRenderingNetwork
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.implicit import ImplicitConfig as JImplicitConfig
from isopoints_tpu.ops.images import sample_random_pixels as j_pixels
from isopoints_tpu.rendering.rasterizer import RasterizationSettings as JSettings
from isopoints_tpu.rendering.texture import neural_texture as j_neural_texture
from isopoints_tpu.training.trainer import compute_loss as j_compute_loss
from isopoints_torch.convert import params_from_jax
from isopoints_torch.models.combined import CombinedConfig, CombinedModel
from isopoints_torch.models.fields import RenderingNetwork, SirenField
from isopoints_torch.models.implicit import ImplicitConfig
from isopoints_torch.rendering.rasterizer import RasterizationSettings
from isopoints_torch.rendering.texture import neural_texture
from isopoints_torch.training.trainer import compute_loss

TEX = dict(dim=9, c_dim=0, hidden_size=32, n_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net_pair(weight_norm=True, seed=0):
    jnet = JRenderingNetwork(**TEX, weight_norm=weight_norm)
    params = jnet.init(jax.random.key(seed))
    tnet = RenderingNetwork(**TEX, weight_norm=weight_norm, device="cpu")
    sd = params_from_jax({"texture": jax.tree.map(np.asarray, params)})
    tnet.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return jnet, params, tnet


def _inputs(n=300, seed=1):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (2, n, 3)).astype(np.float32)
    nrm = rng.normal(size=(2, n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    view = rng.normal(size=(2, n, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    return pts, nrm, view


@pytest.mark.parametrize("weight_norm", [True, False])
def test_rendering_network_matches_jax(weight_norm):
    """Colours and their gradients to the inputs and to every parameter
    (v, g, b or w, b) against `jax.grad` of the same sum."""
    jnet, params, tnet = _net_pair(weight_norm)
    assert tnet.dims == jnet.dims == [33, 32, 32, 3]
    pts, nrm, view = _inputs()
    cot = np.random.RandomState(2).normal(size=pts.shape).astype(np.float32)

    def j_loss(p, a, b, c):
        return jnp.sum(j_neural_texture(jnet, p, a, b, c) * cot)
    j_rgb = np.asarray(j_neural_texture(jnet, params, pts, nrm, view))
    j_g = jax.grad(j_loss, argnums=(0, 1, 2, 3))(params, pts, nrm, view)
    ti = [torch.from_numpy(a).requires_grad_(True) for a in (pts, nrm, view)]
    rgb = neural_texture(tnet, *ti)
    np.testing.assert_allclose(rgb.detach().numpy(), j_rgb, atol=1e-6)
    assert 0.0 <= float(rgb.detach().min()) and float(rgb.detach().max()) <= 1.0
    names = [n for n, _ in tnet.named_parameters()]
    t_g = torch.autograd.grad(torch.sum(rgb * torch.from_numpy(cot)),
                              ti + list(tnet.parameters()))
    for a, b in zip(t_g[:3], j_g[1:]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6 * np.abs(b).max())
    t_params = dict(zip(names, t_g[3:]))
    leaf = {"weight": "w", "bias": "b", "v": "v", "g": "g", "b": "b"}
    for name, g in t_params.items():
        _, i, key = name.split(".")
        ref = np.asarray(j_g[0]["layers"][int(i)][leaf[key]])
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)


def test_neural_texture_with_latent():
    """`neural_texture(latent)` on a network with `c_dim` 5: the latent is
    the conditional code in front of the features (texture.py:31-37);
    colours atol 1e-6 and the latent's gradient against JAX's."""
    jnet = JRenderingNetwork(dim=9, c_dim=5, hidden_size=32, n_layers=2)
    params = jnet.init(jax.random.key(7))
    tnet = RenderingNetwork(dim=9, c_dim=5, hidden_size=32, n_layers=2,
                            device="cpu")
    tnet.load_state_dict({k.split(".", 1)[1]: v for k, v in params_from_jax(
        {"texture": jax.tree.map(np.asarray, params)}).items()})
    pts, nrm, view = _inputs(seed=3)
    lat = np.random.RandomState(4).normal(size=pts.shape[:2] + (5,)).astype(np.float32)
    j_rgb = np.asarray(j_neural_texture(jnet, params, pts, nrm, view,
                                        latent=jnp.asarray(lat)))
    j_g = np.asarray(jax.grad(lambda c: jnp.sum(
        j_neural_texture(jnet, params, pts, nrm, view, latent=c) ** 2))(jnp.asarray(lat)))
    t_lat = torch.from_numpy(lat).requires_grad_(True)
    rgb = neural_texture(tnet, *(torch.from_numpy(a) for a in (pts, nrm, view)),
                         latent=t_lat)
    np.testing.assert_allclose(rgb.detach().numpy(), j_rgb, atol=1e-6)
    torch.sum(rgb ** 2).backward()
    np.testing.assert_allclose(t_lat.grad.numpy(), j_g, atol=1e-6 * np.abs(j_g).max())
    # the code changes the colours
    rgb0 = neural_texture(tnet, *(torch.from_numpy(a) for a in (pts, nrm, view)),
                          latent=torch.zeros_like(t_lat))
    assert float((rgb0 - rgb).detach().abs().max()) > 1e-3


def test_view_direction_and_refusals():
    """The camera's view direction, and the net's latent code and heads:
    its widths as JAX's, an unknown head refused."""
    from test_torch_combined import views
    _, _, jcam, tcam = views()
    pts, _, _ = _inputs(50, seed=4)
    np.testing.assert_allclose(tcam.view_direction(torch.from_numpy(pts)).numpy(),
                               np.asarray(jcam.view_direction(jnp.asarray(pts))),
                               atol=1e-6)
    # a latent code and other heads are carried (tests/test_torch_cloud_utils.py
    # holds them against JAX); an unknown head is refused as JAX refuses it
    net = RenderingNetwork(c_dim=5, hidden_size=8, n_layers=1, device="cpu")
    assert net.dims[0] == JRenderingNetwork(c_dim=5, hidden_size=8, n_layers=1).dims[0]
    assert RenderingNetwork(out_dims={"rgb": 3, "sdf": 1}, hidden_size=8,
                            n_layers=1, device="cpu").dims[-1] == 4
    with pytest.raises(ValueError, match="invalid out_dims key"):
        RenderingNetwork(out_dims={"rgb": 3, "nosuch": 1})


def test_texture_keeps_weight_norm_in_conversion():
    """`params_from_jax` carries the texture's v, g, b as they are, with or
    without `keep_weight_norm` (which folds the decoder's only)."""
    jnet, params, _ = _net_pair()
    tree = {"texture": jax.tree.map(np.asarray, params)}
    for keep in (False, True):
        sd = params_from_jax(tree, keep_weight_norm=keep)
        assert {k.rsplit(".", 1)[1] for k in sd} == {"v", "g", "b"}


# ---------------------------------------------------------------------------
# The combined model's steps with the neural texture
# ---------------------------------------------------------------------------

N_RAYS, N_EIK = 128, 128
CCFG = dict(max_iso_per_batch=128, n_points_per_cloud=400,
            visibility_image_size=48)
RASTER = dict(image_size=48, tile_size=16, max_points_per_tile=128)


def _models(seed):
    jmodel = JCombined(JSiren(hidden_size=64, n_layers=2),
                       JRenderingNetwork(**TEX),
                       cfg=JImplicitConfig(texture_type="neural"),
                       combined_cfg=JCombinedConfig(**CCFG),
                       raster_settings=JSettings(**RASTER))
    params = jmodel.init(jax.random.key(seed))
    tmodel = CombinedModel(
        SirenField(hidden_size=64, n_layers=2, device="cpu"),
        ImplicitConfig(texture_type="neural", use_fused_mlp=True,
                       raytrace={"sampler_in_kernel": True}),
        CombinedConfig(**CCFG),
        raster_settings=RasterizationSettings(**RASTER, use_pallas=True),
        rendering_net=RenderingNetwork(**TEX, device="cpu"))
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                           keep_weight_norm=True))
    return jmodel, params, tmodel


def _grads_match(j_grads, t_grads):
    leaves = jax.tree.leaves(j_grads)
    norm = float(np.sqrt(sum(np.sum(np.asarray(a, np.float64) ** 2)
                             for a in leaves)))
    assert norm > 0
    leaf = {"weight": "w", "bias": "b", "v": "v", "g": "g", "b": "b"}
    for name, g in t_grads.items():
        module, _, i, key = name.split(".")
        ref = np.asarray(j_grads[module]["layers"][int(i)][leaf[key]])
        np.testing.assert_allclose(g.numpy() / norm, ref / norm, rtol=1e-3,
                                   atol=1e-6, err_msg=name)
    tex = [g for n, g in t_grads.items() if n.startswith("texture.")]
    assert len(tex) == 3 * (TEX["n_layers"] + 1)
    assert all(bool(torch.isfinite(g).all()) and bool((g != 0).any()) for g in tex)


@pytest.mark.parametrize("project", [False, True])
def test_step_with_neural_texture_matches_jax(project):
    from test_torch_combined import iso_buffer, views
    from test_torch_train_step import HP, LOSS_KEYS, jax_projected_draws
    from test_torch_train_step import jax_step_draws
    jmodel, params, tmodel = _models(seed=6)
    img, mask, jcam, tcam = views(idx=(0, 2))
    key = jax.random.key(31)
    if project:
        pts, pmask = iso_buffer(jmodel, params, seed=4)
        k_pix, k_loss = jax.random.split(key)
        pixels = j_pixels(k_pix, N_RAYS, img.shape[1:3], batch_size=2)
        eik, proj = jax_projected_draws(k_loss, pts.shape[1],
                                        CCFG["max_iso_per_batch"])
        u, t_pts, t_pmask = None, torch.tensor(pts), torch.tensor(pmask)
        j_pts, j_pmask = jnp.asarray(pts), jnp.asarray(pmask)
    else:
        pixels, k_loss, draws = jax_step_draws(key, 2, img.shape[1:3])
        eik, u, proj = draws.eikonal, draws.u_minsdf, None
        t_pts = t_pmask = j_pts = j_pmask = None

    def loss_fn(p):
        total, (metrics, *_r) = j_compute_loss(
            jmodel, p, j_pts, j_pmask, pixels, jnp.asarray(img),
            jnp.asarray(mask), jcam, k_loss,
            {k: jnp.float32(v) for k, v in HP.items()}, project=project,
            n_eikonal_points=N_EIK)
        return total, metrics
    (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    total, t_metrics, _, _, _ = compute_loss(
        tmodel, t_pts, t_pmask, torch.from_numpy(np.array(pixels)),
        torch.from_numpy(img), torch.from_numpy(mask), tcam, eik, u, HP,
        project=project, proj_draws=proj)
    names = [n for n, _ in tmodel.named_parameters()]
    t_grads = dict(zip(names, torch.autograd.grad(total,
                                                  list(tmodel.parameters()))))
    assert float(j_metrics["n_iso"]) > 0
    cap = CCFG["max_iso_per_batch"] if project else 2 * N_RAYS
    assert abs(float(t_metrics["n_iso"]) - float(j_metrics["n_iso"])) <= 0.01 * cap
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(t_metrics[k].detach()),
                                   float(j_metrics[k]), rtol=1e-4, err_msg=k)
    _grads_match(j_grads, t_grads)


def test_factory_builds_the_uni_siren_config():
    """isopoints_torch/configs/mvr_uni_siren.yml through the factories (the
    model only, on the CPU): the uni arm's SIREN 3×256 with the neural
    texture 3×128 at full width, its schedule, its iso-point budget, the
    synthetic sphere, and the two cuts."""
    from isopoints_torch.config import default_config_path, load_config
    from isopoints_torch.factories import create_model
    from isopoints_torch.ops import fused_mlp
    cfg = load_config("isopoints_torch/configs/mvr_uni_siren.yml",
                      default_config_path())
    assert cfg.data.type == "synthetic" and cfg.training.warm_up_iters == 2
    assert cfg.renderer.raster_params.use_pallas
    model = create_model(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert isinstance(model, CombinedModel)
    assert (model.decoder.hidden_size, model.decoder.n_layers) == (256, 3)
    assert model.texture.dims == [33, 128, 128, 128, 3]
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == {
        "decoder", "texture"}
    rt = model.raytrace_cfg
    assert (rt.coarse_trace_iters, rt.sphere_tracing_iters) == (6, 21)
    assert rt.trace_compact_after == (8, 12) and rt.sampler_fraction == 0.5
    assert rt.sampler_coarse and rt.fused_backstep and rt.coarse_stall_on_cross
    assert rt.sampler_in_kernel and not rt.trace_in_kernel
    assert (model.ccfg.max_iso_per_batch, model.ccfg.n_points_per_cloud) == (3000, 8000)
    assert model.raster_settings.image_size == 256
    fine, coarse = model.trace_sdf_fn(), model.trace_sdf_fn_coarse()
    assert isinstance(fine, fused_mlp.FusedSirenSDF) and fine.precision == "f32"
    assert isinstance(coarse, fused_mlp.FusedSirenSDF) and coarse.precision == "bf16"
    assert fine.fused_ray_sampler.packing_stride == 3
