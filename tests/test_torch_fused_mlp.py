"""Port parity: the fused SIREN MLP (ops/fused_mlp.py) on the CPU, which
is its plain twin, against the JAX Pallas kernel in interpret mode.

Tolerances. Against `precision="highest"` (exact-f32 dots, hardware sin):
values atol 1e-6, input gradients atol 1e-5 — float32 round-off of two
summation orders, the gradient amplified by the ω = 30 layers. Against
the default `"f32x3"` mode (bf16 hi/lo split dots, polynomial sin whose
documented error is ~5.7e-7): values atol 1e-5.

The bf16 mode against JAX's `precision="bf16"` (both round every matmul
operand to bf16 and sum exact products in f32; JAX takes its polynomial
sine, the port the accurate one): the sums in two orders, and the sines
~1e-7 apart, land on the two sides of a bf16 rounding of the next layer's
operand now and then, and at ω = 30 a layer such a flip moves the output
by up to ~2e-5 (measured on this 2×64 field: max 1.8e-5, 99.8% of values
within 1e-5; gradients max 1.5e-3·max|g|, 99.98% within 1e-3·max|g|). So:
values all within 1e-4 and >= 99% within 1e-5; gradients all within
5e-3·max|g| and >= 99% within 1e-3·max|g|. The mode's own error against
f32 on the same points is ~3e-3 (values) and ~4e-2 (gradients), so the
bars tell the bf16 mode from f32 and from a mode that rounds elsewhere.
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


@pytest.fixture(scope="module")
def bf16_pair(pair):
    jfield, params, _ = pair
    tfield = SirenField(hidden_size=64, n_layers=2, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return jfield, params, fused_mlp.make_fused_siren_sdf(tfield, "bf16")


def test_bf16_values_and_grads_match_jax_bf16(pair, bf16_pair):
    jfield, params, sdf = bf16_pair
    assert sdf.precision == "bf16"
    _, j_sdf_grad = jax_fused(jfield, params, interpret=True, precision="bf16")
    x = _x((2000, 3), seed=6)
    v, g = (t.numpy() for t in sdf.sdf_and_grad(torch.from_numpy(x)))
    v_j, g_j = (np.asarray(a) for a in j_sdf_grad(jnp.asarray(x)))
    np.testing.assert_array_equal(sdf(torch.from_numpy(x)).numpy(), v)
    dv, dg = np.abs(v - v_j), np.abs(g - g_j)
    scale = float(np.abs(g_j).max())
    assert dv.max() <= 1e-4 and np.mean(dv <= 1e-5) >= 0.99, dv.max()
    assert dg.max() <= 5e-3 * scale and np.mean(dg <= 1e-3 * scale) >= 0.99
    # the bars are far inside the mode's own error against f32
    v32, g32 = (t.numpy() for t in pair[2].sdf_and_grad(torch.from_numpy(x)))
    assert np.abs(v_j - v32).max() > 10 * 1e-4
    assert np.abs(g_j - g32).max() > 2 * 5e-3 * scale


def test_bf16_exact_sums_are_near_the_plain_bf16(bf16_pair):
    """`exact_sums` (float64 sums rounded once, the chip's reference for
    the kernel's bf16 mode) differs from the float32 sums only by their
    rounding, flipped through a bf16 operand rounding now and then."""
    _, _, sdf = bf16_pair
    x = torch.from_numpy(_x((1000, 3), seed=7))
    v, g = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, x, True)
    v_x, g_x = fused_mlp.siren_sdf_and_grad_plain(sdf.pack, x, True, True)
    np.testing.assert_array_equal(
        v_x.numpy(), fused_mlp.siren_sdf_plain(sdf.pack, x, True, True).numpy())
    dv = (v - v_x).abs()
    assert float(dv.max()) <= 1e-4 and float((dv <= 1e-5).float().mean()) >= 0.99
    assert float((g - g_x).abs().max()) <= 5e-3 * float(g_x.abs().max())


def test_bf16_pack_layout(pair, bf16_pair):
    """The bf16 tensor-core pack: hidden layers (L, H, H) as bf16, no lo
    part, the first layer and the head bf16-rounded in float32, biases as
    they are; the f32 callable's bf16 pack (its coarse sweep's) is the bf16
    callable's, the hi-half rule."""
    _, _, sdf = bf16_pair
    pack = sdf.pack
    tensors, args = pack.mma_net(True)
    w0, b0, wh, wh_lo, bh, wout, bout = tensors
    rnd = lambda a: a.to(torch.bfloat16).to(torch.float32)
    assert wh.dtype == torch.bfloat16 and wh_lo is None
    assert torch.equal(wh.float(), rnd(torch.stack(pack.ws[1:-1])))
    assert torch.equal(w0, rnd(pack.ws[0])) and torch.equal(wout, rnd(pack.ws[-1][0]))
    assert torch.equal(b0, pack.bs[0]) and torch.equal(bh, torch.stack(pack.bs[1:-1]))
    assert torch.equal(bout, pack.bs[-1])
    assert args[3] is None and args[7:] == (64, 2, 30.0, 30.0)
    other = pair[2].pack.mma_net(True)[0]
    for a, b in zip(tensors, other):
        assert (a is None and b is None) or torch.equal(a, b)
    assert pair[2].fused_ray_sampler.packing_stride == 3
    assert sdf.fused_ray_sampler.packing_stride == 2
    assert fused_mlp.KERNEL.launches == 0


def _siren_kernel_model(pack, x, bf16):
    """The kernels' padded SIREN layout (csrc/mlp_mma.cuh) in float32
    PyTorch: the first layer from (Hk, 3), the hidden layers from W (out,
    in), in f32 the tf32 hi + lo parts summed back, in bf16 the bf16 pack
    with every operand rounded where it is stored; sin(ω z) throughout."""
    (w0, b0, wh, wh_lo, bh, wout, bout), args = pack.mma_net(bf16)
    wh = wh.float() if bf16 else wh + wh_lo
    om0, om = args[9:]
    rnd = fused_mlp._round_bf16 if bf16 else (lambda a: a)
    h = rnd(torch.sin(om0 * (rnd(x) @ w0.t() + b0)))
    for l in range(wh.shape[0]):
        h = rnd(torch.sin(om * (h @ wh[l].t() + bh[l])))
    return h @ wout + bout


# (hidden, n_layers): 48 runs padded to 64, 300 and 320 to 384, 512 unpadded
SIREN_LAYOUT_CASES = [(48, 3), (300, 2), (320, 3), (512, 2)]


@pytest.mark.parametrize("hidden,n_layers", SIREN_LAYOUT_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_layout_matches_plain(hidden, n_layers, bf16):
    """The padded SIREN layout at the instance's width equals the plain
    version (a padded unit is sin 0 = 0, and its weights out are zero), and
    the plain version matches JAX's Pallas kernel in interpret mode: f32
    (`highest`) values within 2e-5 and gradients within 2e-5·max(1, |g|);
    bf16 by this file's bars (values all within 1e-4, gradients within
    5e-3·max|g|, >= 99% of gradients within 1e-3·max|g|), the share of
    values within 1e-5 >= 99% up to width 256 and >= 90% above, for the
    reason tests/test_torch_igr.py::test_kernel_layout_matches_plain gives:
    wider float32 sums flip more bf16 roundings of the next operand
    (measured here: 96.7-98.0% of values within 1e-5 at 300-512, 99.7% at
    48)."""
    jfield = JSiren(hidden_size=hidden, n_layers=n_layers)
    params = jfield.init(jax.random.key(hidden))
    tfield = SirenField(hidden_size=hidden, n_layers=n_layers, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    pack = fused_mlp.SirenPack(tfield)
    hk = fused_mlp.kernel_width(hidden)
    tensors, args = pack.mma_net(bf16)
    w0, b0, wh, wh_lo, bh, wout, bout = tensors
    assert (w0.shape, wh.shape, bh.shape, wout.shape) == (
        (hk, 3), (n_layers, hk, hk), (n_layers, hk), (hk,))
    assert args[7:9] == (hk, n_layers) and pack.arch_args()[0] == hk
    for t in (w0[hidden:], b0[hidden:], wh[:, hidden:].float(),
              wh[:, :, hidden:].float(), bh[:, hidden:], wout[hidden:]):
        assert not t.any()
    x = torch.from_numpy(_x((300, 3), seed=8))
    ref = fused_mlp.siren_sdf_plain(pack, x, bf16)
    np.testing.assert_allclose(_siren_kernel_model(pack, x, bf16).numpy(),
                               ref.numpy(), atol=1e-5, rtol=0)
    _, j_sdf_grad = jax_fused(jfield, params, interpret=True,
                              precision="bf16" if bf16 else "highest")
    v_j, g_j = (np.asarray(a) for a in j_sdf_grad(jnp.asarray(x.numpy())))
    v, g = (t.numpy() for t in fused_mlp.siren_sdf_and_grad_plain(pack, x, bf16))
    np.testing.assert_array_equal(v, ref.numpy())
    scale = float(np.abs(g_j).max())
    dv, dg = np.abs(v - v_j), np.abs(g - g_j)
    if bf16:
        bar = 0.99 if hidden <= 256 else 0.9
        assert dv.max() <= 1e-4 and np.mean(dv <= 1e-5) >= bar, dv.max()
        assert dg.max() <= 5e-3 * scale and np.mean(dg <= 1e-3 * scale) >= 0.99
    else:
        assert dv.max() <= 2e-5 and dg.max() <= 2e-5 * max(1.0, scale), (
            dv.max(), dg.max())
