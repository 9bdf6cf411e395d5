"""Port parity: the combined model's projected forward against the JAX
package, on the CPU.

Both packages start from the same SIREN (64 wide, 2 hidden layers, JAX
init, converted), the same synthetic sphere views and the same iso-point
buffer (random cube points Newton-projected by the JAX package). The
random numbers of the projected forward are rebuilt from a JAX key as
isopoints_tpu splits it (models/combined.py:116, 278; the selection scores
and the jitter of `get_visible_iso_points`, the freespace depth
fractions) and handed to the port. The port runs its slice's switches
(fused MLP, rasterizer kernels), which on the CPU are their plain
versions; the JAX side runs its plain field and XLA rasterizer.

Tolerances. Back camera: rotations equal, translations within 1e-6 (a
3-term product in another order). Visibility masks from the same points,
normals and spacing: equal. The visible iso-point set: valid counts within
1% of the capacity (Newton convergence within round-off of the
tolerance), and at least 95% of JAX's valid points with a port point within
1e-5 (the midpoint upsampling is bit-identical on equal seeds,
tests/test_torch_knn.py, but the jittered points are then Newton-projected,
and a point within round-off of the stop converges in one package only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from isopoints_tpu.core.camera import PerspectiveCamera as JCam
from isopoints_tpu.models.combined import CombinedConfig as JCombinedConfig
from isopoints_tpu.models.combined import CombinedModel as JCombined
from isopoints_tpu.models.combined import back_camera as j_back_camera
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.models.fields import sdf_and_grad as j_sdf_and_grad
from isopoints_tpu.models.levelset import project_points_newton as j_newton
from isopoints_tpu.rendering.rasterizer import RasterizationSettings as JSettings
from isopoints_tpu.rendering.rasterizer import splat_spacing as j_splat_spacing
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core.camera import cameras_from_matrices
from isopoints_torch.data.synthetic import make_synthetic_mvr, sphere_sdf
from isopoints_torch.models.combined import (CombinedConfig, CombinedModel,
                                             ProjectedDraws, back_camera)
from isopoints_torch.models.fields import SirenField, sdf_and_grad
from isopoints_torch.models.implicit import ImplicitConfig
from isopoints_torch.rendering.rasterizer import RasterizationSettings

HIDDEN, LAYERS = 64, 2
N_RAYS = 128
CCFG = dict(max_iso_per_batch=128, n_points_per_cloud=400,
            visibility_image_size=48)
RASTER = dict(image_size=48, tile_size=16, max_points_per_tile=128)


def projected_models(seed=0):
    """(JAX model, its params, port model with the slice's switches)."""
    jmodel = JCombined(JSiren(hidden_size=HIDDEN, n_layers=LAYERS),
                       combined_cfg=JCombinedConfig(**CCFG),
                       raster_settings=JSettings(**RASTER))
    params = jmodel.init(jax.random.key(seed))
    tmodel = CombinedModel(
        SirenField(hidden_size=HIDDEN, n_layers=LAYERS, device="cpu"),
        ImplicitConfig(use_fused_mlp=True, raytrace={"sampler_in_kernel": True}),
        CombinedConfig(**CCFG),
        raster_settings=RasterizationSettings(**RASTER, use_pallas=True))
    tmodel.load_state_dict(params_from_jax(
        {"decoder": jax.tree.map(np.asarray, params["decoder"])}))
    return jmodel, params, tmodel


def views(n_views=4, image_size=32, idx=(1, 3)):
    data = make_synthetic_mvr(sphere_sdf(), n_views=n_views,
                              image_size=image_size, device="cpu")
    idx = np.array(idx)
    mats = data["camera_mat"][idx]
    jcam = JCam.create(R=mats[:, :3, :3], T=mats[:, 3, :3],
                       focal_length=data["focal_length"],
                       principal_point=data["principal_point"])
    tcam = cameras_from_matrices(mats, data["focal_length"],
                                 data["principal_point"], device="cpu")
    return data["img.rgb"][idx], data["img.mask"][idx], jcam, tcam


def iso_buffer(jmodel, params, seed=0):
    """A projected iso-point buffer of n_points_per_cloud slots (numpy)."""
    n = CCFG["n_points_per_cloud"]
    pts = np.random.RandomState(seed).uniform(-0.75, 0.75, (1, n, 3)).astype(np.float32)
    res = j_newton(jmodel.trace_sdf_fn(params), jnp.asarray(pts),
                   jnp.ones((1, n), bool))
    return np.asarray(res.points), np.asarray(res.mask)


@pytest.fixture(scope="module")
def world():
    jmodel, params, tmodel = projected_models()
    img, mask, jcam, tcam = views()
    pts, pmask = iso_buffer(jmodel, params)
    assert pmask.sum() > 0.5 * pmask.size
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, img=img,
                mask=mask, jcam=jcam, tcam=tcam, pts=pts, pmask=pmask)


def test_back_camera_matches_jax(world):
    jb, tb = j_back_camera(world["jcam"]), back_camera(world["tcam"])
    for name in ("R", "principal_point", "focal_length"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(tb.T.numpy(), np.asarray(jb.T), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb.camera_center().numpy(),
                               world["tcam"].camera_center().numpy(), atol=1e-6)


@pytest.mark.parametrize("back", [False, True])
def test_visible_points_mask_matches_jax(world, back):
    jm, p, tm = world["jmodel"], world["params"], world["tmodel"]
    pts, pmask = world["pts"], world["pmask"]
    _, jn = j_sdf_and_grad(jm.trace_sdf_fn(p), jnp.asarray(pts))
    sp = j_splat_spacing(jnp.asarray(pts), jnp.asarray(pmask), jm.raster_settings)
    jcam = j_back_camera(world["jcam"]) if back else world["jcam"]
    tcam = back_camera(world["tcam"]) if back else world["tcam"]
    jv = jax.jit(lambda a, b, c, d: jm.visible_points_mask(p, a, b, c, jcam,
                                                           spacing=d))(
        jnp.asarray(pts), jnp.asarray(pmask), jn, sp)
    tv = tm.visible_points_mask(torch.from_numpy(pts), torch.from_numpy(pmask),
                                torch.from_numpy(np.asarray(jn)), tcam,
                                spacing=torch.from_numpy(np.asarray(sp)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if not back:  # the back camera faces away from the cloud in both packages
        assert 0.1 * pmask.sum() < tv.numpy().sum() < 0.9 * pmask.sum()


def test_get_visible_iso_points_matches_jax(world):
    jm, p, tm = world["jmodel"], world["params"], world["tmodel"]
    pts, pmask = world["pts"], world["pmask"]
    key = jax.random.key(3)
    vis = np.random.RandomState(1).uniform(size=pmask.shape) < 0.5
    vis &= pmask
    j_pts, _, j_mask = jax.jit(lambda a, b, c: jm.get_visible_iso_points(
        p, a, b, world["jcam"], key, normals=jnp.zeros_like(a), vis=c))(
            jnp.asarray(pts), jnp.asarray(pmask), jnp.asarray(vis))
    # get_visible_iso_points splits the key it is given
    k_sel, k_off = jax.random.split(key)
    scores = jax.random.uniform(k_sel, pmask.shape)
    offset = jax.random.uniform(k_off, (1, CCFG["max_iso_per_batch"], 3))
    t_pts, _, t_mask = tm.get_visible_iso_points(
        tm.trace_sdf_fn(), torch.from_numpy(pts), torch.from_numpy(pmask),
        torch.from_numpy(np.asarray(scores)), torch.from_numpy(np.asarray(offset)),
        torch.from_numpy(vis))
    jm_, tm_ = np.asarray(j_mask)[0], t_mask.numpy()[0]
    m = CCFG["max_iso_per_batch"]
    assert jm_.sum() > 0.5 * m
    assert abs(int(tm_.sum()) - int(jm_.sum())) <= max(2, 0.01 * m)
    d, _ = cKDTree(t_pts.numpy()[0][tm_]).query(np.asarray(j_pts)[0][jm_])
    assert np.mean(d <= 1e-5) >= 0.95


def test_projected_forward_needs_its_draws(world):
    tm = world["tmodel"]
    pix = torch.zeros(2, 4, 2)
    with pytest.raises(ValueError, match="ProjectedDraws"):
        tm(pix, torch.from_numpy(world["img"]), torch.from_numpy(world["mask"]),
           world["tcam"], None, points=torch.from_numpy(world["pts"]),
           points_mask=torch.from_numpy(world["pmask"]), project=True)
    draws = ProjectedDraws(torch.rand(1, 400), torch.rand(1, 128, 3),
                           torch.rand(2, 4))
    out, new_pts, new_mask = tm(
        pix, torch.from_numpy(world["img"]), torch.from_numpy(world["mask"]),
        world["tcam"], None, points=torch.from_numpy(world["pts"]),
        points_mask=torch.from_numpy(world["pmask"]), project=True,
        draws=draws)
    assert new_pts.shape == (1, 128, 3) and new_mask.shape == (1, 128)
    assert out.sdf_freespace.shape == (2, 4 + 128)
    assert int(out.overflow_trace) == 0


def test_projected_forward_without_offsurface_samples(world):
    """`sample_iso_offsurface=False` (combined.py:304-314) against JAX's, on
    the draws JAX's key gives: the free-space and occupancy points are the
    on-surface ones, detached, both masks False, as in JAX; the visible
    iso-point sets agree at this file's tolerance; and the on-surface
    outputs equal the port's own run with the off-surface samples."""
    jm, p, tm = world["jmodel"], world["params"], world["tmodel"]
    rng = np.random.RandomState(8)
    ndc = rng.uniform(-0.9, 0.9, (2, N_RAYS, 2)).astype(np.float32)
    key = jax.random.key(5)
    jout, j_pts, j_mask = jax.jit(lambda a, b, c, d, e: jm.forward(
        p, a, b, c, world["jcam"], key, points=d, points_mask=e, project=True,
        sample_iso_offsurface=False))(
            *(jnp.asarray(world[k]) if k in world else jnp.asarray(ndc)
              for k in ("ndc", "img", "mask", "pts", "pmask")))
    k_vis, _ = jax.random.split(key)
    k_sel, k_off = jax.random.split(k_vis)
    m = CCFG["max_iso_per_batch"]
    draws = ProjectedDraws(
        torch.from_numpy(np.array(jax.random.uniform(k_sel, world["pmask"].shape))),
        torch.from_numpy(np.array(jax.random.uniform(k_off, (1, m, 3)))),
        torch.rand(2, N_RAYS, generator=torch.Generator().manual_seed(0)))
    args = (torch.from_numpy(ndc), torch.from_numpy(world["img"]),
            torch.from_numpy(world["mask"]), world["tcam"], None)
    kw = dict(points=torch.from_numpy(world["pts"]),
              points_mask=torch.from_numpy(world["pmask"]), project=True,
              draws=draws)
    out, t_pts, t_mask = tm(*args, sample_iso_offsurface=False, **kw)
    ref, r_pts, r_mask = tm(*args, **kw)
    def arr(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for o, name in ((out, "port"), (jout, "jax")):
        pts_ = arr(o.iso_points)
        for pf, fm in ((o.p_freespace, o.freespace_mask),
                       (o.p_occupancy, o.occupancy_mask)):
            np.testing.assert_array_equal(arr(pf), pts_, err_msg=name)
            assert arr(fm).shape == pts_.shape[:2] and not arr(fm).any()
    assert not out.p_freespace.requires_grad and out.iso_points.requires_grad
    with torch.no_grad():
        np.testing.assert_array_equal(out.sdf_freespace.numpy(),
                                      tm.decoder.sdf(out.p_freespace).numpy())
    # the on-surface half is the run with the off-surface samples
    for name in ("iso_points", "iso_mask", "iso_normals", "iso_rgb", "iso_rgb_gt"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert torch.equal(t_pts, r_pts) and torch.equal(t_mask, r_mask)
    assert ref.p_freespace.shape[1] == N_RAYS + m
    # against JAX: the visible iso-point set, at this file's tolerance
    jm_, tm_ = np.asarray(j_mask)[0], t_mask.numpy()[0]
    assert jm_.sum() > 0.5 * m
    assert abs(int(tm_.sum()) - int(jm_.sum())) <= max(2, 0.01 * m)
    d, _ = cKDTree(t_pts.numpy()[0][tm_]).query(np.asarray(j_pts)[0][jm_])
    assert np.mean(d <= 1e-5) >= 0.95
    assert out.iso_points.shape == jout.iso_points.shape
