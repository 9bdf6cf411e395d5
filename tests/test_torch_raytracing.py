"""Port parity: the IDR ray tracer (models/raytracing.py) against the JAX
`ray_trace`, on the plain field and on the fused kernels (the port's CPU
twins against the JAX Pallas kernels in interpret mode, "highest"), with
the min-SDF step fractions drawn from the JAX key and passed to the port.

Tolerances: every mask must be equal; points and depths use atol 1e-5
(float32 round-off of two MLP summation orders, carried through a few
sphere-tracing steps and an 8-step secant).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.core.camera import (PerspectiveCamera as JCam,
                                       look_at_view_transform as j_look_at)
from isopoints_tpu.models import raytracing as jrt
from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.ops.pallas_mlp import make_fused_siren_sdf as jax_fused
from isopoints_torch.convert import params_from_jax
from isopoints_torch.models import raytracing as trt
from isopoints_torch.models.fields import SirenField
from isopoints_torch.ops import fused_mlp

N_RAYS = 128
CFG = dict(n_steps=16, n_secant_steps=8)


@pytest.fixture(scope="module")
def setup():
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(0))
    tfield = SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    # two views of the unit sphere, rays through random pixels
    R, T = j_look_at([1.6, 1.6], [20.0, -35.0], [30.0, 200.0])
    cam = JCam.create(R=R, T=T, focal_length=1.5)
    rng = np.random.RandomState(1)
    ndc = rng.uniform(-0.9, 0.9, (2, N_RAYS, 2)).astype(np.float32)
    _, dirs = cam.ndc_to_rays(jnp.asarray(ndc))
    cam_pos = cam.camera_center()[:, None, :]
    obj = rng.uniform(size=(2, N_RAYS)) > 0.4
    return jfield, params, tfield, np.array(cam_pos), np.array(dirs), obj


def _compare(r_j, r_t):
    for name in ("network_object_mask", "sampler_mask", "mask_intersect"):
        np.testing.assert_array_equal(getattr(r_t, name).numpy(),
                                      np.asarray(getattr(r_j, name)), name)
    np.testing.assert_allclose(r_t.dists.numpy(), np.asarray(r_j.dists),
                               atol=1e-5)
    np.testing.assert_allclose(r_t.points.numpy(), np.asarray(r_j.points),
                               atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_ray_trace_matches_jax(setup, fused, training):
    jfield, params, tfield, cam_pos, dirs, obj = setup
    key = jax.random.key(7)
    u = np.asarray(jax.random.uniform(jax.random.split(key)[1],
                                      (CFG["n_steps"],)))
    j_cfg = jrt.RayTracingConfig(sampler_in_kernel=fused, **CFG)
    t_cfg = trt.RayTracingConfig(sampler_in_kernel=fused, **CFG)
    if fused:
        j_sdf = jax_fused(jfield, params, interpret=True, precision="highest")[0]
        t_sdf = fused_mlp.make_fused_siren_sdf(tfield)
    else:
        j_sdf = lambda x: jfield.sdf(params, x)
        t_sdf = tfield.sdf
    r_j = jrt.ray_trace(j_sdf, jnp.asarray(cam_pos), jnp.asarray(dirs),
                        jnp.asarray(obj), key, j_cfg, training=training)
    with torch.no_grad():
        r_t = trt.ray_trace(t_sdf, torch.from_numpy(cam_pos),
                            torch.from_numpy(dirs), torch.from_numpy(obj),
                            torch.from_numpy(u), t_cfg, training=training)
    # the fixture must exercise every branch: hits, sampler rays, misses
    assert 0 < int(r_j.network_object_mask.sum()) < obj.size
    assert int(r_j.sampler_mask.sum()) > 0
    _compare(r_j, r_t)


def test_sphere_intersection_matches_jax(setup):
    _, _, _, cam_pos, dirs, _ = setup
    cam = np.broadcast_to(cam_pos, dirs.shape)
    ref = jrt.intersection_with_unit_sphere(jnp.asarray(cam), jnp.asarray(dirs))
    out = trt.intersection_with_unit_sphere(torch.from_numpy(cam.copy()),
                                            torch.from_numpy(dirs))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("field,value", [
    ("coarse_trace_iters", 3), ("trace_compact_after", (4, 8)),
    ("fused_backstep", True), ("sampler_coarse", True),
    ("sampler_presweep", 8), ("trace_in_kernel", True),
    ("sampler_fraction", 0.5), ("trace_gate_end_front", True)])
def test_unported_config_values_raise(field, value):
    with pytest.raises(NotImplementedError):
        trt.RayTracingConfig(**{field: value})
    # the JAX config keeps the same field names
    assert field in {f.name for f in dataclasses.fields(jrt.RayTracingConfig)}
