"""The fused SIREN kernel's tensor-core tile, modelled on the CPU.

csrc/fused_mlp.cu runs the SIREN stack on csrc/mlp_mma.cuh's tile: the
hidden products in 3xTF32 (every operand split into tf32 hi and lo, the
weights once on the host by `SirenPack.mma_net`), each 16-wide k-chunk's
products lo·hi + hi·lo + hi·hi summed into a zeroed tile and added to the
float32 accumulator, and the first layer, the head, the biases and the
sine epilogue in float32. A CUDA kernel cannot run here, so this file
models that arithmetic in PyTorch on the kernel's own pack and holds it
to a tenth of the tolerances `chip_smoke.py` holds the kernel to (values
2e-5, input gradients 1e-4·max(1, |g|)): values within 2e-6 and gradients
within 1e-5·max(1, |g|), against the plain version and against the JAX
kernel's `highest` mode in interpret mode. One tf32 pass instead of three
misses that by far, so the split is what carries the precision.
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
from isopoints_torch.utils import fma

CHUNK = 16       # tf32 elements of K per k-chunk (64 bytes)
VALUE_TOL = 2e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """A 3×64 SIREN (three hidden layers) from the JAX package's init, and
    300 points in [−1, 1]³."""
    jfield = JSiren(hidden_size=64, n_layers=3)
    params = jfield.init(jax.random.key(3))
    tfield = SirenField(hidden_size=64, n_layers=3, device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)})
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    x = np.random.RandomState(4).uniform(-1, 1, (300, 3)).astype(np.float32)
    return jfield, params, fused_mlp.SirenPack(tfield), x


def _mm(a, w_hi, w_lo, passes):
    """a (N, K) @ W (out, K)^T as the tile forms it: per k-chunk the
    products (lo·hi, hi·lo, hi·hi over each k8 step, or hi·hi alone with
    passes=1) summed into a zeroed tile, then added to the accumulator."""
    a_hi = fused_mlp.tf32_round(a)
    a_lo = fused_mlp.tf32_round(a - a_hi)
    acc = torch.zeros((a.shape[0], w_hi.shape[0]))
    for k0 in range(0, a.shape[1], CHUNK):
        t = torch.zeros_like(acc)
        for k in range(k0, min(k0 + CHUNK, a.shape[1]), 8):
            s = slice(k, k + 8)
            if passes == 3:
                t = t + a_lo[:, s] @ w_hi[:, s].t()
                t = t + a_hi[:, s] @ w_lo[:, s].t()
            t = t + a_hi[:, s] @ w_hi[:, s].t()
        acc = acc + t
    return acc


def _tile_model(pack, x, passes=3):
    """The SIREN tile on its pack: value and the three tangent rows."""
    tensors, args = pack.mma_net()
    w0, b0, wh, wh_lo, bh, wout, bout = tensors
    hidden, n_hidden, om0, om = args[7:]
    n = x.shape[0]

    def act(z, omega, jz):
        w = omega * z
        d = omega * torch.cos(w)
        return torch.sin(w), d[:, None, :] * jz

    z = fma(x[:, 2:3], w0[:, 2], fma(x[:, 1:2], w0[:, 1], x[:, 0:1] * w0[:, 0])) + b0
    h, jac = act(z, om0, w0.t().expand(n, 3, hidden))
    for l in range(n_hidden):
        z = _mm(h, wh[l], wh_lo[l], passes) + bh[l]
        jz = _mm(jac.reshape(-1, hidden), wh[l], wh_lo[l], passes).reshape(jac.shape)
        h, jac = act(z, om, jz)
    return h @ wout + bout, jac @ wout


def _close(v, g, v_ref, g_ref):
    """Largest value error, and largest gradient error over its bound."""
    scale = max(1.0, float(np.abs(g_ref).max()))
    return (float(np.abs(v - v_ref).max()),
            float(np.abs(g - g_ref).max()) / (GRAD_TOL * scale))


def test_tf32x3_model_holds_a_tenth_of_the_kernel_tolerance(pair):
    jfield, params, pack, x = pair
    xt = torch.from_numpy(x)
    v, g = (t.numpy() for t in _tile_model(pack, xt))
    v_p, g_p = (t.numpy() for t in fused_mlp.siren_sdf_and_grad_plain(pack, xt))
    np.testing.assert_allclose(v, fused_mlp.siren_sdf_plain(pack, xt).numpy(),
                               atol=VALUE_TOL, rtol=0)
    err_v, err_g = _close(v, g, v_p, g_p)
    assert err_v <= VALUE_TOL and err_g <= 1.0, (err_v, err_g)
    _, j_sdf_grad = jax_fused(jfield, params, interpret=True, precision="highest")
    v_j, g_j = (np.asarray(a) for a in j_sdf_grad(jnp.asarray(x)))
    err_v, err_g = _close(v, g, v_j, g_j)
    assert err_v <= VALUE_TOL and err_g <= 1.0, (err_v, err_g)


def test_one_tf32_pass_is_far_outside(pair):
    _, _, pack, x = pair
    xt = torch.from_numpy(x)
    v, g = (t.numpy() for t in _tile_model(pack, xt, passes=1))
    v_p, g_p = (t.numpy() for t in fused_mlp.siren_sdf_and_grad_plain(pack, xt))
    err_v, err_g = _close(v, g, v_p, g_p)
    # past the kernel's own tolerances (value 2e-5, gradient 10x GRAD_TOL)
    assert err_v > 10 * VALUE_TOL and err_g > 10.0, (err_v, err_g)


def test_mma_pack_layout(pair):
    """The tensor-core pack: hidden layers (L, H, H) as (out, in), split
    into tf32 hi and lo that sum back to the weights; the other layers as
    they are; pointers of the tensors; the ω's."""
    _, _, pack, _ = pair
    tensors, args = pack.mma_net()
    w0, b0, wh, wh_lo, bh, wout, bout = tensors
    assert w0.shape == (64, 3) and b0.shape == (64,)
    assert wh.shape == wh_lo.shape == (3, 64, 64) and bh.shape == (3, 64)
    assert wout.shape == (64,) and bout.shape == (1,)
    full = torch.stack(pack.ws[1:-1])
    assert torch.equal(wh, fused_mlp.tf32_round(full))
    assert torch.equal(wh_lo, fused_mlp.tf32_round(full - wh))
    for part in (wh, wh_lo):   # tf32: the low 13 mantissa bits clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert float((wh + wh_lo - full).abs().max()) <= 2.0 ** -21 * float(full.abs().max())
    assert torch.equal(bh, torch.stack(pack.bs[1:-1]))
    assert torch.equal(w0, pack.ws[0]) and torch.equal(wout, pack.ws[-1][0])
    assert all(t.is_contiguous() for t in tensors)
    assert args[:7] == tuple(t.data_ptr() for t in tensors)
    assert args[7:] == (64, 3, 30.0, 30.0)
    assert pack.mma_net() is pack.mma_net()
