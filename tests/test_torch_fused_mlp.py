"""Port parity: the fused SIREN MLP (ops/fused_mlp.py) on the CPU, which
is its plain twin, against the JAX Pallas kernel in interpret mode.

Tolerances. Against `precision="highest"` (exact-f32 dots, hardware sin):
values atol 1e-6, input gradients atol 1e-5 — float32 round-off of two
summation orders, the gradient amplified by the ω = 30 layers. Against
the default `"f32x3"` mode (bf16 hi/lo split dots, polynomial sin whose
documented error is ~5.7e-7): values atol 1e-5.
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
from isopoints_torch.ops import fused_mlp


@pytest.fixture(scope="module")
def pair():
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(0))
    tfield = SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return jfield, params, fused_mlp.make_fused_siren_sdf(tfield)


def _x(shape, seed=2):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def test_values_and_grads_match_highest(pair):
    jfield, params, sdf = pair
    j_sdf, j_sdf_grad = jax_fused(jfield, params, interpret=True,
                                  precision="highest")
    x = _x((777, 3))
    np.testing.assert_allclose(sdf(torch.from_numpy(x)).numpy(),
                               np.asarray(j_sdf(jnp.asarray(x))), atol=1e-6)
    v, g = sdf.sdf_and_grad(torch.from_numpy(x))
    v_ref, g_ref = j_sdf_grad(jnp.asarray(x))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-5)


def test_values_match_default_f32x3(pair):
    jfield, params, sdf = pair
    j_sdf, _ = jax_fused(jfield, params, interpret=True)
    x = _x((500, 3), seed=3)
    np.testing.assert_allclose(sdf(torch.from_numpy(x)).numpy(),
                               np.asarray(j_sdf(jnp.asarray(x))), atol=1e-5)


def test_twin_grad_matches_autograd(pair):
    """The forward-mode tangent twin equals the plain field's autograd."""
    _, _, sdf = pair
    x = torch.from_numpy(_x((2, 17, 5, 3), seed=4))
    v, g = sdf.sdf_and_grad(x)
    assert v.shape == (2, 17, 5) and g.shape == (2, 17, 5, 3)
    xr = x.clone().requires_grad_(True)
    ref = fused_mlp.siren_sdf_plain(sdf.pack, xr.reshape(-1, 3)).reshape(v.shape)
    (g_ref,) = torch.autograd.grad(ref.sum(), xr)
    np.testing.assert_allclose(v.numpy(), ref.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), atol=1e-5)


def test_cpu_path_launches_no_kernel(pair):
    _, _, sdf = pair
    before = fused_mlp.KERNEL.launches
    x = torch.from_numpy(_x((64, 3)))
    sdf(x)
    sdf.sdf_and_grad(x)
    assert fused_mlp.KERNEL.launches == before == 0


def test_detached_and_input_checks(pair):
    _, _, sdf = pair
    x = torch.from_numpy(_x((8, 3))).requires_grad_(True)
    assert not sdf(x).requires_grad
    with pytest.raises(TypeError):
        sdf(x.detach().double())
