"""Port parity: SirenField and sdf_and_grad against the JAX fields.

The same numpy-made points go through both packages; the port's weights
are converted from the JAX init (isopoints_torch.convert). Tolerance:
atol 1e-5 with rtol 1e-5. Both sides run float32 on the CPU and differ
only in the summation order of the matmuls (~1e-7 relative at these
widths); the gradients pass through up to three ω = 30 sine layers, which
amplify that round-off, and the parameter gradients sum over 333 points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.models import fields as jf
from isopoints_torch.convert import params_from_jax
from isopoints_torch.models import fields as tf

TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(hidden=64, n_layers=2, seed=0):
    jfield = jf.SirenField(hidden_size=hidden, n_layers=n_layers)
    params = jfield.init(jax.random.key(seed))
    tfield = tf.SirenField(hidden_size=hidden, n_layers=n_layers, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return jfield, params, tfield


def _points(shape, seed=1):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(333, 3), (2, 17, 5, 3)])
def test_values_match(shape):
    jfield, params, tfield = _pair()
    x = _points(shape)
    ref = np.asarray(jfield.sdf(params, jnp.asarray(x)))
    with torch.no_grad():
        out = tfield.sdf(torch.from_numpy(x)).numpy()
    assert out.shape == shape[:-1]
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("grad_mode", [True, False])
def test_input_grad_matches(grad_mode):
    jfield, params, tfield = _pair()
    x = _points((257, 3))
    v_ref, g_ref = jf.sdf_and_grad(lambda p: jfield.sdf(params, p),
                                   jnp.asarray(x))
    with torch.set_grad_enabled(grad_mode):
        v, g = tf.sdf_and_grad(tfield.sdf, torch.from_numpy(x))
    assert g.requires_grad == grad_mode
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_ref), **TOL)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), **TOL)


def test_param_grads_match():
    """θ-gradient of a loss that uses both the value and the input
    gradient (the eikonal path differentiates through sdf_and_grad)."""
    jfield, params, tfield = _pair(n_layers=3)
    x = _points((333, 3))

    def jloss(p):
        v, g = jf.sdf_and_grad(lambda q: jfield.sdf(p, q), jnp.asarray(x))
        return jnp.sum(v ** 2) + jnp.mean((jnp.linalg.norm(g, axis=-1) - 1) ** 2)

    g_ref = jax.grad(jloss)(params)
    v, g = tf.sdf_and_grad(tfield.sdf, torch.from_numpy(x))
    loss = torch.sum(v ** 2) + torch.mean((torch.linalg.norm(g, dim=-1) - 1) ** 2)
    loss.backward()
    for i, lin in enumerate(tfield.layers):
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   np.asarray(g_ref["layers"][i]["w"]), **TOL)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(g_ref["layers"][i]["b"]), **TOL)


def test_weight_norm_params_fold():
    """{v, g, b} layers convert to w = g·v/‖v‖_row as the JAX _linear."""
    rng = np.random.RandomState(3)
    v = rng.randn(5, 4).astype(np.float32)
    g = rng.rand(5, 1).astype(np.float32) + 0.5
    b = rng.randn(5).astype(np.float32)
    lp = {"v": jnp.asarray(v), "g": jnp.asarray(g), "b": jnp.asarray(b)}
    x = rng.randn(7, 4).astype(np.float32)
    ref = np.asarray(jf._linear(lp, jnp.asarray(x)))
    sd = params_from_jax({"m": {"layers": [{"v": v, "g": g, "b": b}]}})
    out = torch.nn.functional.linear(torch.from_numpy(x), sd["m.layers.0.weight"],
                                     sd["m.layers.0.bias"]).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["sample_network", "directional"])
def test_sample_networks_match(which):
    """Implicit-differentiation re-attachment (levelset.py:484-519): the
    value is the frozen point, the θ-gradient of a weighted sum of the
    outputs matches JAX's."""
    from isopoints_tpu.models import levelset as jl
    from isopoints_torch.models import levelset as tl

    jfield, params, tfield = _pair()
    p = _points((2, 33, 3), seed=5) * 0.6
    cam = _points((2, 1, 3), seed=7) * 2.0
    rays = p - cam                       # each point lies on its camera ray
    wts = _points((2, 33, 3), seed=8)

    def run_jax(prm):
        f = lambda q: jfield.sdf(prm, q)
        if which == "sample_network":
            out = jl.sample_network(f, jnp.asarray(p))
        else:
            out = jl.directional_sample_network(f, jnp.asarray(p),
                                                jnp.asarray(rays),
                                                jnp.asarray(cam))
        return jnp.sum(out * jnp.asarray(wts)), out

    (_, out_ref), g_ref = jax.value_and_grad(run_jax, has_aux=True)(params)
    args = [torch.from_numpy(a) for a in (p, rays, cam)]
    if which == "sample_network":
        out = tl.sample_network(tfield.sdf, args[0])
    else:
        out = tl.directional_sample_network(tfield.sdf, *args)
    torch.sum(out * torch.from_numpy(wts)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), **TOL)
    # the directional network divides by <∇f, ray>, which amplifies the
    # round-off of near-grazing rays: gradients in units of their largest
    # entry
    for i, lin in enumerate(tfield.layers):
        ref = np.asarray(g_ref["layers"][i]["w"])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(lin.weight.grad.numpy() / scale,
                                   ref / scale, atol=1e-5, rtol=1e-4)
