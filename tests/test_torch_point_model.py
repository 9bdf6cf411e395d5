"""Port parity: the DSS point model and its renderer stack against the JAX
package, on the CPU: the angle helpers, the compositor, `PointCloud`,
`render_pointcloud`, `PointModel` (forward and the gradients of its five
parameters), `prune_points` and the factory on `dss_point.yml`.

The rasterizer's stages and backward run their plain versions on CPU
tensors. Inputs are made with numpy from a seed and handed to both packages
as numpy arrays; the JAX model's parameters reach the port through
`convert.point_params_from_jax`. The JAX functions run under `jax.jit`.

Tolerances: angles and the compositor 1e-6; RGBA within 1e-6 with the alpha
maps equal (the fragment maps are equal); visibility and in-mask flags
equal; the loss within rtol 1e-6; gradients within 1e-5·max(1, max|g|)
per parameter (the occupancy backward's sums run in another order);
`log_size` gets no gradient in the port and an exact 0 in JAX (the scale
enters the cutoff detached in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.core.camera import look_at_view_transform as j_look_at
from isopoints_tpu.core.cloud import PointCloud as JCloud
from isopoints_tpu.models.point import PointModel as JPointModel
from isopoints_tpu.models.point import PointModelConfig as JPointConfig
from isopoints_tpu.rendering.compositor import (
    norm_weighted_sum_composite as j_norm_composite)
from isopoints_tpu.rendering.rasterizer import RasterizationSettings as JSettings
from isopoints_tpu.rendering.renderer import render_pointcloud as j_render
from isopoints_tpu.utils.mathutils import (angles_to_vectors as j_a2v,
                                           vectors_to_angles as j_v2a)
from isopoints_torch.config import load_config
from isopoints_torch.convert import POINT_PARAMS, point_params_from_jax
from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.core.cloud import PointCloud
from isopoints_torch.factories import create_model
from isopoints_torch.models.point import PointModel, PointModelConfig
from isopoints_torch.rendering.compositor import (gather_fragments,
                                                  norm_weighted_sum_composite)
from isopoints_torch.rendering.rasterizer import RasterizationSettings
from isopoints_torch.rendering.renderer import render_pointcloud
from isopoints_torch.utils.mathutils import angles_to_vectors, vectors_to_angles


def _unit(rng, shape):
    v = rng.randn(*shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_angles_match_jax():
    v = _unit(np.random.RandomState(0), (2, 300, 3))
    ja, je = (np.asarray(a) for a in j_v2a(jnp.asarray(v)))
    ta, te = vectors_to_angles(torch.from_numpy(v))
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-6, rtol=0)
    np.testing.assert_allclose(te.numpy(), je, atol=1e-6, rtol=0)
    back = angles_to_vectors(ta, te).numpy()
    np.testing.assert_allclose(back, np.asarray(j_a2v(jnp.asarray(ja), jnp.asarray(je))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(back, v, atol=1e-6, rtol=0)


@pytest.mark.parametrize("pre_gathered", [False, True])
def test_compositors_match_jax(pre_gathered):
    """The normalised compositor, gathering the features itself or given
    the rows the renderer gathered."""
    rng = np.random.RandomState(1 + pre_gathered)
    b, S, K, P, C = 2, 8, 5, 40, 3
    idx = rng.randint(-1, P, (b, S, S, K))
    idx[:, 0, 0] = -1                                # an empty pixel
    w = rng.uniform(size=(b, S, S, K)).astype(np.float32)
    f = rng.uniform(size=(b, P, C)).astype(np.float32)
    j = np.asarray(jax.jit(j_norm_composite)(jnp.asarray(idx), jnp.asarray(w),
                                             jnp.asarray(f)))
    ti, tw, tf = (torch.from_numpy(a) for a in (idx, w, f))
    rows = gather_fragments(tf, ti) if pre_gathered else None
    t = norm_weighted_sum_composite(ti, tw, tf, gathered_features=rows).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t[:, 0, 0], 0.0)


def _cameras(b=2):
    R, T = j_look_at([2.0] * b, [10.0] * b, [30.0 * i for i in range(b)])
    R, T = np.array(R), np.array(T)
    return (JCam.create(R=R, T=T, focal_length=2.0),
            PerspectiveCamera.create(R=R, T=T, focal_length=2.0))


def test_cloud_and_render_match_jax():
    rng = np.random.RandomState(2)
    n, S = 400, 32
    d = _unit(rng, (n, 3))
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    jcam, tcam = _cameras(1)
    jc = JCloud.create(jnp.asarray(0.5 * d), normals=jnp.asarray(d),
                       features=jnp.asarray(rgb))
    tc = PointCloud.create(torch.from_numpy(0.5 * d), normals=torch.from_numpy(d),
                           features=torch.from_numpy(rgb))
    assert tc.batch_size == 1 and tc.points.shape[1] == n and bool(tc.mask.all())
    assert torch.equal(tc.with_features(2 * tc.features).features,
                       2 * torch.from_numpy(rgb)[None])
    js = JSettings(image_size=S, tile_size=8)
    ts = RasterizationSettings(image_size=S, tile_size=8)
    j = jax.jit(j_render, static_argnums=2)(jc, jcam, js)
    t = render_pointcloud(tc, tcam, ts)
    np.testing.assert_array_equal(t.rgba[..., 3].numpy(), np.asarray(j.rgba[..., 3]))
    np.testing.assert_allclose(t.rgba.numpy(), np.asarray(j.rgba), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t.visibility.numpy(), np.asarray(j.visibility))
    assert t.rgba[..., 3].sum() > 50


def _models(use_pallas, n=256, S=32):
    rng = np.random.RandomState(3)
    d = _unit(rng, (1, n, 3))
    jm = JPointModel(JPointConfig(n_points_per_cloud=n),
                     JSettings(image_size=S, tile_size=8, use_pallas=use_pallas))
    params = jm.init(jax.random.key(0), points=jnp.asarray(0.5 * d),
                     normals=jnp.asarray(d))
    params["colors"] = jnp.asarray(rng.uniform(size=(1, n, 3)).astype(np.float32))
    tm = PointModel(PointModelConfig(n_points_per_cloud=n),
                    RasterizationSettings(image_size=S, tile_size=8,
                                          use_pallas=use_pallas), device="cpu")
    tm.load_state_dict(point_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}))
    mask_img = (rng.uniform(size=(2, S, S, 1)) < 0.7).astype(np.float32)
    target = rng.uniform(size=(2, S, S, 4)).astype(np.float32)
    return jm, params, tm, mask_img, target


@pytest.mark.parametrize("use_pallas", [False, True])
def test_point_model_forward_and_gradients_match_jax(use_pallas):
    """rgba, visibility and in-mask flags, and the gradients of all five
    parameters under Σ(alpha − target)² + Σ|rgb − target_rgb|
    (tests/test_models.py:135-150, with a colour term), in two views."""
    jm, params, tm, mask_img, target = _models(use_pallas)
    jcam, tcam = _cameras(2)

    def j_loss(p):
        out = jm.forward(p, jcam, mask_img=jnp.asarray(mask_img))
        return (jnp.sum((out.rgba[..., 3] - target[..., 3]) ** 2)
                + jnp.sum(jnp.abs(out.rgba[..., :3] - target[..., :3]))), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    out = tm(tcam, mask_img=torch.from_numpy(mask_img))
    tgt = torch.from_numpy(target)
    loss = (torch.sum((out.rgba[..., 3] - tgt[..., 3]) ** 2)
            + torch.sum(torch.abs(out.rgba[..., :3] - tgt[..., :3])))
    loss.backward()
    np.testing.assert_array_equal(out.rgba[..., 3].detach().numpy(),
                                  np.asarray(jout.rgba[..., 3]))
    np.testing.assert_allclose(out.rgba.detach().numpy(), np.asarray(jout.rgba),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out.visibility.numpy(), np.asarray(jout.visibility))
    np.testing.assert_array_equal(out.inmask.numpy(), np.asarray(jout.inmask))
    assert 0.3 < float(out.inmask.float().mean()) < 0.95
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for k in POINT_PARAMS[:4]:
        g, want = getattr(tm, k).grad.numpy(), np.asarray(jg[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(g, want, rtol=0, err_msg=k,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    assert tm.log_size.grad is None and float(jg["log_size"]) == 0.0
    # prune: points with an exactly zero gradient leave the activation mask
    active = torch.ones(1, tm.points.shape[1], dtype=torch.bool)
    pruned = PointModel.prune_points(tm.points.grad, active)
    want = np.asarray(jm.prune_points(params, jg["points"], jnp.asarray(active.numpy())))
    np.testing.assert_array_equal(pruned.numpy(), want)
    assert 0 < int(pruned.sum()) < tm.points.shape[1]


def test_point_model_init_and_factory():
    g = torch.Generator().manual_seed(0)
    m = PointModel(PointModelConfig(n_points_per_cloud=64), generator=g, device="cpu")
    assert m.points.shape == (1, 64, 3) and float(m.points.detach().abs().max()) <= 0.75
    radial = m.points / m.points.norm(dim=-1, keepdim=True)
    np.testing.assert_allclose(m.normals().detach().numpy(), radial.detach().numpy(),
                               atol=1e-6)
    assert {k for k, _ in m.named_parameters()} == set(POINT_PARAMS)
    # the cloud's IMLS mesh (ported: tests/test_torch_generator.py holds it
    # against JAX's)
    verts, faces = m.generate_mesh(resolution=16)
    assert len(faces) > 0 and np.isfinite(verts).all()
    cfg = load_config("isopoints_torch/configs/dss_point.yml")
    model = create_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(model, PointModel)
    assert model.points.shape == (1, 5000, 3)
    s = model.raster_settings
    assert (s.image_size, s.points_per_pixel, s.tile_size, s.max_points_per_tile,
            s.use_pallas, s.backward_patch_pixels, s.use_pallas_backward) == (
                256, 5, 16, 256, True, 64, None)
