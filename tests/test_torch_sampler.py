"""Port parity: the fused dense ray sampler (ops/fused_sampler.py) on the
CPU, which is its plain twin, against the JAX Pallas sampler kernel in
interpret mode (`precision="highest"`).

Tolerances: the picked depths `t_pick` and `t_min` must be equal (they are
proposal depths formed by the same float32 arithmetic, and the pick is an
argmin). `f_pick` and `z_secant` use atol 1e-5: float32 round-off of two
MLP summation orders, and the secant divides by value differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.models.fields import SirenField as JSiren
from isopoints_tpu.ops.pallas_mlp import make_fused_siren_sdf as jax_fused
from isopoints_torch.convert import params_from_jax
from isopoints_torch.models.fields import SirenField
from isopoints_torch.ops import fused_mlp, fused_sampler
from isopoints_torch.utils import linspace01


@pytest.fixture(scope="module")
def samplers():
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(0))
    j_sdf, _ = jax_fused(jfield, params, interpret=True, precision="highest")
    tfield = SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return j_sdf.fused_ray_sampler, fused_mlp.make_fused_siren_sdf(tfield)


def _rays(n=193, seed=0):
    """Rays from z = −2 toward the origin with t-intervals that straddle
    the field's zero set (some crossing, some not, some empty)."""
    rng = np.random.RandomState(seed)
    cam = np.broadcast_to(np.float32([0.0, 0.0, -2.0]), (1, n, 3)).copy()
    ang = rng.uniform(-0.6, 0.6, (1, n, 2))
    dirs = np.stack([np.tan(ang[..., 0]), np.tan(ang[..., 1]),
                     np.ones((1, n))], axis=-1)
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    t_lo = rng.uniform(0.8, 1.2, (1, n)).astype(np.float32)
    t_hi = (t_lo + rng.uniform(0.0, 2.2, (1, n))).astype(np.float32)
    t_hi[0, :7] = t_lo[0, :7]
    return cam, dirs, t_lo, t_hi


@pytest.mark.parametrize("kind,n_secant", [("linspace", 8), ("random", 0),
                                           ("linspace", 0)])
def test_sampler_matches_jax(samplers, kind, n_secant):
    j_sampler, sdf = samplers
    arrays = _rays()
    steps = (linspace01(16).numpy() if kind == "linspace" else
             np.random.RandomState(5).uniform(0, 1, 16).astype(np.float32))
    ref = j_sampler(*(jnp.asarray(a) for a in arrays), jnp.asarray(steps),
                    n_secant=n_secant)
    out = sdf.fused_ray_sampler(*(torch.from_numpy(a) for a in arrays),
                                torch.from_numpy(steps), n_secant=n_secant)
    t_pick, f_pick, t_min, z_sec = (o.numpy() for o in out)
    r_pick, r_f, r_min, r_sec = (np.asarray(o) for o in ref)
    assert t_pick.shape == (1, 193)
    np.testing.assert_array_equal(t_pick, r_pick)
    np.testing.assert_array_equal(t_min, r_min)
    np.testing.assert_allclose(f_pick, r_f, atol=1e-5)
    # the secant is only meaningful on rays with a sign change
    crossing = r_f < 0
    assert crossing.sum() > 10
    np.testing.assert_allclose(z_sec[crossing], r_sec[crossing], atol=1e-5)


def test_linspace01_matches_jnp():
    for n in (2, 16, 100):
        np.testing.assert_array_equal(linspace01(n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_cpu_sampler_launches_no_kernel(samplers):
    _, sdf = samplers
    cam, dirs, t_lo, t_hi = (torch.from_numpy(a) for a in _rays(32))
    sdf.fused_ray_sampler(cam, dirs, t_lo, t_hi, linspace01(8))
    assert fused_sampler.KERNEL.launches == 0
    with pytest.raises(NotImplementedError):
        sdf.fused_ray_sampler(cam, dirs, t_lo, t_hi, linspace01(8),
                              coarse_sweep=True)
