"""Port parity: cameras (core/camera.py) and image sampling (ops/images.py)
against the JAX package, on numpy-made inputs.

Tolerance atol 1e-5 (1e-6 for the pure index arithmetic): float32 on both
sides; only einsum summation order and trigonometric rounding differ.
"""

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
