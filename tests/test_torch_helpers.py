"""Port parity: the JAX package's small public helpers, each against its
JAX counterpart on the CPU.

- `CameraSampler` (core/camera.py:186) draws from a `torch.Generator`, so
  its numbers are not JAX's: both are held to the ranges and the order
  (distances in the range and sorted far to near, elevation and azimuth in
  their degree ranges, the look-at jitter within 0.05), and the port's
  cameras to JAX's `look_at_view_transform` of the port's own draws.
- `to_homogen`, `RunningStat` (utils/mathutils.py:95, :134): bit for bit
  on the same inputs (concatenation; Welford's update is the same float32
  operations in the same order).
- JAX's `ndc_to_pix` / `pix_to_ndc` (utils/mathutils.py:110, :124) are
  ops/images.py's `ndc_to_pix_coords` / `pix_to_ndc_coords` in the port,
  which form the same map with other float32 roundings: within 4 float32
  ulps of the pixel coordinate.
- `field_grad` (models/fields.py:383): on the same converted SIREN, within
  1e-5·max(1, |g|) (float32 sums in two orders, amplified by ω = 30).
- `add_file_handler` (logger.py:46): the same record lands in the file,
  without colours, in both.
- `set_deterministic_seed` (rng.py:14): Python's and numpy's generators
  seeded alike in both packages; the port returns a seeded
  `torch.Generator` where JAX returns a root key.
"""

import logging
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu import logger as jlogger
from isopoints_tpu import rng as jrng
from isopoints_tpu.core import camera as jcamera
from isopoints_tpu.models import fields as jfields
from isopoints_tpu.utils import mathutils as jmath
from isopoints_torch import logger as tlogger
from isopoints_torch import rng as trng
from isopoints_torch.convert import params_from_jax
from isopoints_torch.core import camera as tcamera
from isopoints_torch.models import fields as tfields
from isopoints_torch.ops.images import ndc_to_pix_coords, pix_to_ndc_coords
from isopoints_torch.utils import mathutils as tmath


@pytest.mark.parametrize("sort_distance", [True, False])
def test_camera_sampler_ranges_and_order(sort_distance):
    kw = dict(batch_size=64, distance_range=(2.0, 3.5), sort_distance=sort_distance,
              camera_params={"focal_length": 1.5})
    t_cams = tcamera.CameraSampler(**kw).sample(torch.Generator().manual_seed(0))
    j_cams = jcamera.CameraSampler(**kw).sample(jax.random.key(0))
    for cams, centre in ((t_cams, t_cams.camera_center().numpy()),
                         (j_cams, np.asarray(j_cams.camera_center()))):
        assert np.asarray(cams.R).shape == (64, 3, 3)
        np.testing.assert_allclose(np.asarray(cams.focal_length), 1.5)
        # the look-at jitter moves the centre's distance from the origin by
        # at most |at| <= 0.05·√3
        d = np.linalg.norm(centre, axis=-1)
        assert d.min() >= 2.0 - 0.087 and d.max() <= 3.5 + 0.087
        if sort_distance:
            assert np.all(np.diff(d) <= 0.087 * 2)
        # every camera looks at a point within the jitter of the origin
        R = np.asarray(cams.R)
        axis = R[:, :, 2]                          # the view direction, world frame
        t = -(centre * axis).sum(-1)               # closest approach to the origin
        miss = np.linalg.norm(centre + t[:, None] * axis, axis=-1)
        assert miss.max() <= 0.05 * np.sqrt(3) + 1e-5
    # the port's cameras are JAX's look-at transform of the port's draws
    g = torch.Generator().manual_seed(0)
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=g)
    dist = u((64,), 2.0, 3.5)
    if sort_distance:
        dist = torch.sort(dist, descending=True).values
    elev, azim, at = u((64,), -90.0, 90.0), u((64,), -180.0, 180.0), u((64, 3), -0.05, 0.05)
    R_j, T_j = jcamera.look_at_view_transform(jnp.asarray(dist.numpy()),
                                              jnp.asarray(elev.numpy()),
                                              jnp.asarray(azim.numpy()),
                                              at=jnp.asarray(at.numpy()))
    np.testing.assert_allclose(t_cams.R.numpy(), np.asarray(R_j), atol=1e-6)
    np.testing.assert_allclose(t_cams.T.numpy(), np.asarray(T_j), atol=1e-5)


def test_to_homogen_and_running_stat():
    rs = np.random.RandomState(0)
    x = rs.randn(5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(tmath.to_homogen(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmath.to_homogen(jnp.asarray(x))))
    t_st, j_st = tmath.RunningStat((40,)), jmath.RunningStat((40,))
    for _ in range(6):
        v = rs.randn(40).astype(np.float32)
        m = rs.rand(40) < 0.6
        t_st = t_st.update(torch.from_numpy(v), torch.from_numpy(m))
        j_st = j_st.update(jnp.asarray(v), jnp.asarray(m))
    for a in ("n", "mean", "m2", "variance"):
        np.testing.assert_allclose(getattr(t_st, a).numpy(),
                                   np.asarray(getattr(j_st, a)), rtol=0, atol=1e-7)
    assert int(t_st.n.max()) >= 4


def test_ndc_pix_maps_are_images_coords():
    rs = np.random.RandomState(1)
    size = (384, 512)
    ndc = rs.uniform(-1, 1, (1000, 2)).astype(np.float32)
    pix_t = ndc_to_pix_coords(torch.from_numpy(ndc), size).numpy()
    pix_j = np.asarray(jmath.ndc_to_pix(jnp.asarray(ndc), size))
    ulp = np.spacing(np.float32(max(size)))
    assert np.abs(pix_t - pix_j).max() <= 4 * ulp
    back_t = pix_to_ndc_coords(torch.from_numpy(np.array(pix_j)), size).numpy()
    back_j = np.asarray(jmath.pix_to_ndc(jnp.asarray(pix_j), size))
    assert np.abs(back_t - back_j).max() <= 4 * np.spacing(np.float32(1.0))
    np.testing.assert_allclose(back_t, ndc, atol=1e-5)


def test_field_grad_matches_jax():
    jfield = jfields.SirenField(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(0))
    tfield = tfields.SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    x = np.random.RandomState(2).uniform(-1, 1, (300, 3)).astype(np.float32)
    g_j = np.asarray(jfields.field_grad(lambda p: jfield.sdf(params, p))(jnp.asarray(x)))
    g_t = tfields.field_grad(tfield.sdf)(torch.from_numpy(x))
    assert g_t.requires_grad        # differentiable in the parameters
    g_t = g_t.detach().numpy()
    assert g_t.shape == (300, 3)
    assert np.abs(g_t - g_j).max() <= 1e-5 * max(1.0, float(np.abs(g_j).max()))


def test_add_file_handler(tmp_path):
    lines = {}
    for name, mod in (("jax", jlogger), ("torch", tlogger)):
        log = logging.getLogger(f"helpers_test_{name}")
        log.setLevel(logging.INFO)
        log.propagate = False
        path = tmp_path / f"{name}.log"
        mod.add_file_handler(log, str(path))
        log.warning("step %d done", 7)
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)
        lines[name] = path.read_text().strip()
    for text in lines.values():
        assert "WARNING helpers_test_" in text and text.endswith("step 7 done")
        assert "\x1b[" not in text
    strip = lambda s: s.split(" ", 1)[1].replace("_jax", "").replace("_torch", "")
    assert strip(lines["jax"]) == strip(lines["torch"])


def test_set_deterministic_seed():
    draws = {}
    for name, fn in (("jax", jrng.set_deterministic_seed),
                     ("torch", trng.set_deterministic_seed)):
        out = fn(11)
        draws[name] = (random.random(), np.random.rand(3))
        if name == "torch":
            assert isinstance(out, torch.Generator)
            a = torch.rand(4, generator=out)
            assert torch.equal(a, torch.rand(4, generator=torch.Generator().manual_seed(11)))
            t0 = torch.rand(2)
            trng.set_deterministic_seed(11)
            random.random(), np.random.rand(3)
            assert torch.equal(torch.rand(2), t0)
    assert draws["jax"][0] == draws["torch"][0]
    np.testing.assert_array_equal(draws["jax"][1], draws["torch"][1])
