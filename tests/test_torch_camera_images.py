"""Port parity: cameras (core/camera.py) and image sampling (ops/images.py)
against the JAX package, on numpy-made inputs.

Tolerance atol 1e-5 (1e-6 for the pure index arithmetic, and for
`view_to_world`, `pixels_to_rays`, `project_ndc(with_view_depth=False)`
on identical R and T): float32 on both sides; only einsum summation order
and trigonometric rounding differ. The clip planes are plain floats on
both sides and compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core import camera as jcam
from isopoints_tpu.ops import images as jimg
from isopoints_torch.core import camera as tcam
from isopoints_torch.ops import images as timg


def _cams():
    dist, elev, azim = [2.0, 1.7, 2.5], [10.0, -40.0, 75.0], [0.0, 130.0, -60.0]
    jR, jT = jcam.look_at_view_transform(dist, elev, azim, at=(0.05, 0.0, -0.02))
    tR, tT = tcam.look_at_view_transform(dist, elev, azim, at=(0.05, 0.0, -0.02))
    kw = dict(focal_length=((2.0, 1.8),), principal_point=((0.03, -0.02),))
    return (jcam.PerspectiveCamera.create(R=jR, T=jT, **kw),
            tcam.PerspectiveCamera.create(R=tR, T=tT, **kw))


def test_look_at_and_centers_match():
    jc, tc = _cams()
    np.testing.assert_allclose(tc.R.numpy(), np.asarray(jc.R), atol=1e-6)
    np.testing.assert_allclose(tc.T.numpy(), np.asarray(jc.T), atol=1e-5)
    np.testing.assert_allclose(tc.camera_center().numpy(),
                               np.asarray(jc.camera_center()), atol=1e-5)
    np.testing.assert_allclose(tc.focal_length.numpy(),
                               np.asarray(jc.focal_length))


def test_project_and_rays_match():
    jc, tc = _cams()
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.6, 0.6, (3, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(tc.project_ndc(torch.from_numpy(pts)).numpy(),
                               np.asarray(jc.project_ndc(jnp.asarray(pts))),
                               atol=1e-5)
    ndc = rng.uniform(-1, 1, (3, 40, 2)).astype(np.float32)
    jo, jd = jc.ndc_to_rays(jnp.asarray(ndc))
    to, td = tc.ndc_to_rays(torch.from_numpy(ndc))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


def test_pixel_convention():
    """pytorch3d NDC: pixel (i) center at (S − 2i − 1)/S, +X left, +Y up."""
    pix, ndc = timg.arange_pixels((4, 6), batch_size=2)
    jpix, jndc = jimg.arange_pixels((4, 6), batch_size=2)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(jpix))
    np.testing.assert_allclose(ndc.numpy(), np.asarray(jndc), atol=1e-7)
    assert ndc[0, 0, 0] == pytest.approx(5.0 / 6.0)
    assert ndc[0, 0, 1] == pytest.approx(3.0 / 4.0)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_image_at_ndc_matches(mode):
    rng = np.random.RandomState(1)
    img = rng.rand(2, 9, 11, 3).astype(np.float32)
    ndc = rng.uniform(-1.2, 1.2, (2, 64, 2)).astype(np.float32)
    ref = jimg.sample_image_at_ndc(jnp.asarray(img), jnp.asarray(ndc), mode=mode)
    out = timg.sample_image_at_ndc(torch.from_numpy(img), torch.from_numpy(ndc),
                                   mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_random_pixels_in_image_and_ndc_round_trip():
    g = torch.Generator().manual_seed(0)
    ndc = timg.sample_random_pixels(g, 500, (16, 24), batch_size=2)
    assert ndc.shape == (2, 500, 2)
    pix = timg.ndc_to_pix_coords(ndc, (16, 24))
    assert float(pix.min()) >= 0.0
    assert float(pix[..., 0].max()) <= 23.0 and float(pix[..., 1].max()) <= 15.0
    np.testing.assert_allclose(timg.pix_to_ndc_coords(pix, (16, 24)).numpy(),
                               ndc.numpy(), atol=1e-6)


def _same_cams(znear=0.1, zfar=100.0):
    """Both packages' cameras on the JAX package's R and T."""
    jc, _ = _cams()
    R, T = np.array(jc.R), np.array(jc.T)
    kw = dict(focal_length=((2.0, 1.8),), principal_point=((0.03, -0.02),),
              znear=znear, zfar=zfar)
    return (jcam.PerspectiveCamera.create(R=R, T=T, **kw),
            tcam.PerspectiveCamera.create(R=R, T=T, **kw))


def test_view_to_world_and_round_trip():
    """JAX's tests/test_core.py:55-69 on the port, and the port against JAX."""
    jc, tc = _same_cams()
    rng = np.random.RandomState(3)
    pv = rng.uniform(-0.6, 0.6, (3, 50, 3)).astype(np.float32)
    pv[..., 2] += 2.0
    np.testing.assert_allclose(tc.view_to_world(torch.from_numpy(pv)).numpy(),
                               np.asarray(jc.view_to_world(jnp.asarray(pv))),
                               atol=1e-6)
    pts = torch.from_numpy(rng.normal(0, 0.3, (3, 50, 3)).astype(np.float32))
    np.testing.assert_allclose(tc.view_to_world(tc.world_to_view(pts)).numpy(),
                               pts.numpy(), atol=1e-5)
    cv = tc.world_to_view(tc.camera_center()[:, None, :])
    np.testing.assert_allclose(cv.numpy(), 0.0, atol=1e-5)
    # (B, 3) and (B, ..., 3) shapes go through
    assert tc.view_to_world(torch.from_numpy(pv[:, :2, None])).shape == (3, 2, 1, 3)


def test_pixels_to_rays_matches_and_hits_projection():
    """JAX's tests/test_core.py:72-82 on the port, and the port against JAX."""
    jc, tc = _same_cams()
    h, w = 48, 64
    pix = np.random.RandomState(4).uniform(0, 63, (3, 40, 2)).astype(np.float32)
    to, td = tc.pixels_to_rays(torch.from_numpy(pix), (h, w))
    jo, jd = jc.pixels_to_rays(jnp.asarray(pix), (h, w))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    ndc = tc.project_ndc(to[:, None, :] + td * 2.5)
    np.testing.assert_allclose(timg.ndc_to_pix_coords(ndc[..., :2], (h, w)).numpy(),
                               pix, atol=1e-3)


def test_project_ndc_inverse_depth():
    jc, tc = _same_cams()
    pts = np.random.RandomState(5).uniform(-0.6, 0.6, (3, 50, 3)).astype(np.float32)
    t = tc.project_ndc(torch.from_numpy(pts), with_view_depth=False)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(jc.project_ndc(jnp.asarray(pts), with_view_depth=False)),
        atol=1e-6)
    view_z = tc.world_to_view(torch.from_numpy(pts))[..., 2]
    np.testing.assert_allclose(t[..., 2].numpy(), 1.0 / view_z.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(
        t[..., :2].numpy(), tc.project_ndc(torch.from_numpy(pts))[..., :2].numpy())


def test_clip_planes_are_floats_carried_by_replace():
    import dataclasses
    jc, tc = _same_cams(0.5, 3.0)
    assert (tc.znear, tc.zfar) == (jc.znear, jc.zfar) == (0.5, 3.0)
    assert type(tc.znear) is float and type(tc.zfar) is float
    d = tcam.PerspectiveCamera.create()
    assert (d.znear, d.zfar) == (jcam.PerspectiveCamera.create().znear,
                                 jcam.PerspectiveCamera.create().zfar) == (0.1, 100.0)
    moved = dataclasses.replace(tc, T=tc.T + 1.0)
    assert (moved.znear, moved.zfar) == (0.5, 3.0)


def test_camera_sampler_takes_camera_params():
    kw = dict(batch_size=3, camera_params={"znear": 0.5})
    t = tcam.CameraSampler(**kw).sample(torch.Generator().manual_seed(0))
    j = jcam.CameraSampler(**kw).sample(jax.random.key(0))
    assert (t.znear, t.zfar) == (j.znear, j.zfar) == (0.5, 100.0)
    t = tcam.CameraSampler(batch_size=2, camera_params={
        "znear": 0.25, "zfar": 9.0, "focal_length": 1.5}).sample(
            torch.Generator().manual_seed(1))
    assert (t.znear, t.zfar) == (0.25, 9.0)
    np.testing.assert_array_equal(t.focal_length.numpy(), np.full((2, 2), 1.5))


@pytest.mark.parametrize("hw", [(16, 24), (7, 5)])
def test_random_integer_pixels(hw):
    """`continuous=False`: integer pixel centres, columns in [0, W) and rows
    in [0, H), every one of them reached; the continuous default keeps its
    stream bit for bit."""
    h, w = hw
    ndc = timg.sample_random_pixels(torch.Generator().manual_seed(0), 4000, hw,
                                    batch_size=2, continuous=False)
    assert ndc.shape == (2, 4000, 2)
    pix = timg.ndc_to_pix_coords(ndc, hw)
    np.testing.assert_allclose(pix.numpy(), np.round(pix.numpy()), atol=1e-4)
    col, row = np.round(pix[..., 0].numpy()), np.round(pix[..., 1].numpy())
    assert set(np.unique(col)) == set(range(w))
    assert set(np.unique(row)) == set(range(h))
    # the NDC of integer centres, as JAX maps them
    np.testing.assert_allclose(
        ndc.numpy(), np.asarray(jimg.pix_to_ndc_coords(
            jnp.asarray(np.stack([col, row], -1).astype(np.float32)), hw)),
        atol=1e-6)
    g = torch.Generator().manual_seed(0)
    u = torch.rand((2, 500, 2), generator=g)
    cont = timg.sample_random_pixels(torch.Generator().manual_seed(0), 500, hw,
                                     batch_size=2)
    np.testing.assert_array_equal(cont.numpy(), timg.pix_to_ndc_coords(
        u * torch.tensor([w - 1.0, h - 1.0]), hw).numpy())
