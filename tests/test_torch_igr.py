"""Port parity: the IGR field (`SDFField`), its fused MLP's plain versions
and the kernel's packed layout, against the JAX package on the CPU.

The JAX parameters go through `params_from_jax(keep_weight_norm=True)`,
so the port's field holds the same `v, g, b` leaves.

Tolerances:
- `SDFField` values atol 1e-6, parameter gradients atol 1e-5 (float32
  sums in two orders; the softplus β = 100 amplifies the round-off of the
  gradient by up to 100).
- f32 plain version against the JAX kernel's `highest` mode: values atol
  1e-6, input gradients atol 1e-5.
- bf16 plain version against the JAX kernel's `bf16` mode: both round every
  operand to bf16 and sum exact products in float32, in different orders,
  so an activation whose float32 value lies within round-off of a bf16
  rounding boundary rounds one bf16 ulp (2^-8 relative) apart. 99% of the
  values and gradients agree within 1e-5; every one within 1e-3, the
  mode's own error against f32.
- the kernels' padded layout (`mma_net`), evaluated by a PyTorch model of
  its arithmetic in float32 (the tf32 hi + lo parts summed back in f32),
  against the plain version: atol 1e-6 (f32) and exact operands in bf16,
  atol 1e-5.
- the fused IGR kernel's 3xTF32 f32 mode, emulated here (tf32 by a bit
  mask, round to nearest with ties away; hi·hi + hi·lo + lo·hi in float32)
  on its tensor-core pack, on a fitted 4×256 field with a skip: within a
  tenth of the kernel's own f32 tolerances against the plain version,
  values 2e-6 and input gradients 1e-5·max(1, |g|). This holds the
  precision argument of the design: the split loses ~2^-22 relative per
  product, far inside what the kernel is allowed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isopoints_tpu.misc.checkpoints import CheckpointIO
from isopoints_tpu.models import fields as jf
from isopoints_tpu.ops.pallas_mlp import make_fused_igr_sdf as jax_fused_igr
from isopoints_torch.convert import load_jax_npz, params_from_jax
from isopoints_torch.models import fields as tf
from isopoints_torch.ops import fused_mlp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(hidden=64, n_layers=4, num_frequencies=0, seed=0, **kw):
    jfield = jf.SDFField(hidden_size=hidden, n_layers=n_layers,
                         num_frequencies=num_frequencies, **kw)
    params = jfield.init(jax.random.key(seed))
    tfield = tf.SDFField(hidden_size=hidden, n_layers=n_layers,
                         num_frequencies=num_frequencies, device="cpu", **kw)
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)},
                         keep_weight_norm=True)
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return jfield, params, tfield


def _points(shape, seed=1, scale=1.0):
    return (np.random.RandomState(seed).uniform(-1, 1, shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("num_frequencies", [0, 6])
def test_sdffield_matches_jax(num_frequencies):
    """Values and the θ-gradient (through v, g, b) of a loss on them."""
    jfield, params, tfield = _pair(num_frequencies=num_frequencies)
    x = _points((333, 3))
    jx = jnp.asarray(x)

    def jloss(p):
        return jnp.mean(jfield.sdf(p, jx) ** 2)

    ref = np.asarray(jfield.sdf(params, jx))
    g_ref = jax.grad(jloss)(params)
    out = tfield.sdf(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    torch.mean(out ** 2).backward()
    for i, lin in enumerate(tfield.layers):
        for leaf in ("v", "g", "b"):
            np.testing.assert_allclose(
                getattr(lin, leaf).grad.numpy(),
                np.asarray(g_ref["layers"][i][leaf]), atol=1e-5,
                err_msg=f"layer {i} {leaf}")


def test_sdffield_widths_and_init():
    """The bench field's widths 3→256→256→256→253→[253+3]→1, and the
    geometric init's pos-enc columns zeroed."""
    f = tf.SDFField(hidden_size=256, n_layers=4, num_frequencies=0,
                    device="cpu")
    assert [tuple(l.v.shape) for l in f.layers] == [
        (256, 3), (256, 256), (256, 256), (253, 256), (1, 256)]
    g = tf.SDFField(hidden_size=64, n_layers=5, num_frequencies=6,
                    generator=torch.Generator().manual_seed(0), device="cpu")
    assert g.layers[0].v.shape == (64, 39)
    assert g.layers[3].v.shape == (25, 64)
    assert torch.all(g.layers[0].v[:, 3:] == 0)
    assert torch.all(g.layers[4].v[:, -36:] == 0)
    plain = tf.SDFField(hidden_size=32, n_layers=2, weight_norm=False,
                        skip_in=(), device="cpu")
    assert isinstance(plain.layers[0], torch.nn.Linear)


def test_convert_keeps_weight_norm():
    jfield, params, _ = _pair(hidden=32, n_layers=2)
    tree = {"decoder": jax.tree.map(np.asarray, params)}
    kept = params_from_jax(tree, keep_weight_norm=True)
    folded = params_from_jax(tree)
    assert sorted(kept) == sorted(f"decoder.layers.{i}.{k}" for i in range(3)
                                  for k in ("v", "g", "b"))
    assert sorted(folded) == sorted(f"decoder.layers.{i}.{k}" for i in range(3)
                                    for k in ("weight", "bias"))


def test_load_jax_checkpoint_keeps_weight_norm(tmp_path):
    jfield, params, _ = _pair(hidden=32, n_layers=2)
    CheckpointIO(str(tmp_path), model={"decoder": params}).save("model.npz", it=1)
    sd = load_jax_npz(str(tmp_path / "model.npz"), keep_weight_norm=True)
    ref = params_from_jax({"decoder": jax.tree.map(np.asarray, params)},
                          keep_weight_norm=True)
    assert sorted(sd) == sorted(ref)
    for k in sd:
        assert torch.equal(sd[k], ref[k])


@pytest.fixture(scope="module")
def igr64():
    """The bench field's shape at hidden 64: 4 layers, skip width 61."""
    jfield, params, tfield = _pair(hidden=64, n_layers=4)
    assert tfield.layers[3].v.shape[0] == 61
    return jfield, params, tfield


def test_plain_f32_matches_jax_highest(igr64):
    jfield, params, tfield = igr64
    j_sdf, j_grad = jax_fused_igr(jfield, params, interpret=True,
                                  precision="highest")
    sdf = fused_mlp.make_fused_igr_sdf(tfield)
    x = _points((611, 3), seed=2)
    np.testing.assert_allclose(sdf(torch.from_numpy(x)).numpy(),
                               np.asarray(j_sdf(jnp.asarray(x))), atol=1e-6)
    v, g = sdf.sdf_and_grad(torch.from_numpy(x))
    v_ref, g_ref = j_grad(jnp.asarray(x))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-5)


def test_plain_bf16_matches_jax_bf16(igr64):
    jfield, params, tfield = igr64
    j_sdf, j_grad = jax_fused_igr(jfield, params, interpret=True,
                                  precision="bf16")
    sdf = fused_mlp.make_fused_igr_sdf(tfield, "bf16")
    x = _points((611, 3), seed=3)
    v_ref, g_ref = (np.asarray(a) for a in j_grad(jnp.asarray(x)))
    v = sdf(torch.from_numpy(x)).numpy()
    v2, g = (a.numpy() for a in sdf.sdf_and_grad(torch.from_numpy(x)))
    np.testing.assert_allclose(v, np.asarray(j_sdf(jnp.asarray(x))), atol=1e-3)
    np.testing.assert_allclose(v2, v_ref, atol=1e-3)
    np.testing.assert_allclose(g, g_ref, atol=1e-3)
    assert np.mean(np.abs(v - v_ref) <= 1e-5) >= 0.99
    assert np.mean(np.abs(g - g_ref) <= 1e-5) >= 0.99
    # and the mode really is coarse: ~1e-3 away from the f32 values
    fine = fused_mlp.make_fused_igr_sdf(tfield)(torch.from_numpy(x)).numpy()
    assert 1e-4 < np.abs(v - fine).max() < 1e-2


def test_plain_grad_matches_autograd(igr64):
    """The forward-mode tangent plain version equals autograd of the
    field."""
    _, _, tfield = igr64
    sdf = fused_mlp.make_fused_igr_sdf(tfield)
    x = torch.from_numpy(_points((2, 33, 3), seed=4))
    v, g = sdf.sdf_and_grad(x)
    assert v.shape == (2, 33) and g.shape == (2, 33, 3)
    v_ref, g_ref = tf.sdf_and_grad(tfield.sdf, x)
    np.testing.assert_allclose(v.numpy(), v_ref.detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_ref.detach().numpy(), atol=1e-5)


def _kernel_model(pack, x, bf16):
    """The kernels' padded layout (csrc/mlp_mma.cuh) in float32 PyTorch:
    first layer from (H, 3), hidden layers from W (out, in), in f32 the
    tf32 hi + lo parts summed back in f32, in bf16 the bf16 pack; the skip
    written into the last three columns and the row scaled by 1/√2,
    operands rounded to bf16 where they are stored."""
    (w0, b0, wh, wh_lo, bh, wout, bout), _ = pack.mma_net(bf16)
    wh = wh.float() if bf16 else wh + wh_lo
    hidden, n_hidden, skip, final_tanh = pack.arch_args()
    rnd = fused_mlp._round_bf16 if bf16 else (lambda a: a)
    c = torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32)

    def store(a, layer):
        if skip >> layer & 1:
            a = torch.cat([a[:, :hidden - 3], x], dim=-1) * c
        return rnd(a)

    h = store(tf.softplus_beta(rnd(x) @ w0.t() + b0), 1)
    for l in range(n_hidden):
        h = store(tf.softplus_beta(h @ wh[l].t() + bh[l]), l + 2)
    out = h @ wout + bout
    return torch.tanh(out) if final_tanh else out


# (hidden, n_layers, skip_in): the kernels' instance widths are the multiples
# of 32 up to 256, 384 and 512 (fused_mlp.KERNEL_WIDTHS), so 48 runs padded to
# 64 and 300 and 320 to 384, 512 unpadded; a skip mid-stack and into the head
LAYOUT_CASES = [(64, 4, (4,)), (64, 4, (2,)), (48, 3, (2,)), (300, 4, (2,)),
                (320, 4, (4,)), (512, 3, (2,))]


@pytest.mark.parametrize("hidden,n_layers,skip", LAYOUT_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_kernel_layout_matches_plain(hidden, n_layers, skip, bf16):
    """The kernels' padded layout at the instance's width equals the plain
    version (the padded units hold softplus(0)/β, which only zero columns
    read), and at the widths the tests above do not take the plain version
    matches JAX's Pallas kernel in interpret mode: f32 (`highest`) values
    within 2e-5 and input gradients within 2e-5·max(1, |g|); bf16 within
    1e-3 (as `test_plain_bf16_matches_jax_bf16`) and within 1e-5 on >= 99%
    of outputs up to width 256, on >= 90% above.

    Why 90% above 256: in the bf16 mode a float32 sum in another order
    lands on the other side of a bf16 rounding of the next operand now and
    then, and wider sums do so more often. On the same bf16 operands JAX's
    kernel itself is within 1e-5 of the exactly formed sums (`exact_sums`)
    on only 97.3-98.7% of values and 96.8-97.9% of gradients at 300-512,
    and the port's plain version within 1e-5 of JAX's on 97.3-98.3% and
    94.9-95.7%; a mode that leaves the tangent rows or the point unrounded
    is within 1e-5 of JAX's on 1.1-5.3% (and the tangent one within 1e-3
    everywhere). The bf16 cases take fields without weight norm: the two
    packages fold it with float32 norms summed in other orders, and a
    weight one float32 ulp apart can round to bf16 one bf16 ulp apart
    (width 300 with weight norm: 79% of values within 1e-5)."""
    jfield, params, tfield = _pair(hidden=hidden, n_layers=n_layers, skip_in=skip,
                                   weight_norm=not (bf16 and hidden > 64))
    pack = fused_mlp.IgrPack(tfield)
    hk = fused_mlp.kernel_width(hidden)
    assert pack.arch_args()[0] == hk and hk in fused_mlp.KERNEL_WIDTHS
    w0, b0, wh, wh_lo, bh, wout, bout = pack.mma_net(bf16)[0]
    n_mid = n_layers - 1
    assert (w0.shape, wh.shape, bh.shape, wout.shape) == (
        (hk, 3), (n_mid, hk, hk), (n_mid, hk), (hk,))
    assert wh.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert (wh_lo is None) == bf16
    # every padded input column of the layers past the first is zero (a
    # skip layer's point columns sit last), and so is every padded output
    for l, w in enumerate(list(wh.float()) + [wout[None]], start=1):
        lo, hi = (hidden - 3, hk - 3) if l in skip else (hidden, hk)
        assert not w[:, lo:hi].any()
    out0 = hidden - 3 if 1 in skip else hidden
    assert not w0[out0:].any() and not b0[out0:].any()
    x = torch.from_numpy(_points((300, 3), seed=5))
    ref = fused_mlp.igr_sdf_plain(pack, x, bf16)
    np.testing.assert_allclose(_kernel_model(pack, x, bf16).numpy(),
                               ref.numpy(), atol=1e-5 if bf16 else 1e-6)
    if hidden == 64:   # held against JAX by the tests above
        return
    _, j_grad = jax_fused_igr(jfield, params, interpret=True,
                              precision="bf16" if bf16 else "highest")
    v_j, g_j = (np.asarray(a) for a in j_grad(jnp.asarray(x.numpy())))
    v, g = (a.numpy() for a in fused_mlp.igr_sdf_and_grad_plain(pack, x, bf16))
    np.testing.assert_array_equal(v, ref.numpy())
    if bf16:
        np.testing.assert_allclose(v, v_j, atol=1e-3)
        np.testing.assert_allclose(g, g_j, atol=1e-3)
        bar = 0.99 if hidden <= 256 else 0.9
        assert np.mean(np.abs(v - v_j) <= 1e-5) >= bar
        assert np.mean(np.abs(g - g_j) <= 1e-5) >= bar
    else:
        np.testing.assert_allclose(v, v_j, atol=2e-5, rtol=0)
        np.testing.assert_allclose(g, g_j, rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(g_j).max())))


def test_kernel_width_rule():
    """A field runs on the smallest instance at or above its width; above
    the widest the pack refuses with a ValueError naming both, on any
    device (the CUDA wrappers build the pack before they launch)."""
    assert [fused_mlp.kernel_width(h) for h in (3, 32, 48, 256, 257, 300, 384, 385, 512)
            ] == [32, 32, 64, 256, 384, 384, 384, 512, 512]
    _, _, tfield = _pair(hidden=520, n_layers=2, skip_in=())
    pack = fused_mlp.IgrPack(tfield)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="520.*512|512.*520"):
            pack.mma_net(bf16)
    siren = fused_mlp.SirenPack(tf.SirenField(hidden_size=544, n_layers=1, device="cpu"))
    with pytest.raises(ValueError, match="544"):
        siren.mma_net()
    with pytest.raises(ValueError, match="544"):
        siren.arch_args()


def test_dispatch_and_cpu_route():
    jfield, params, tfield = _pair(hidden=32, n_layers=2)
    assert isinstance(fused_mlp.make_fused_sdf_fn(tfield),
                      fused_mlp.FusedIgrSDF)
    posenc = tf.SDFField(hidden_size=32, n_layers=2, num_frequencies=4,
                         device="cpu")
    assert fused_mlp.make_fused_sdf_fn(posenc) is None
    siren = tf.SirenField(hidden_size=32, n_layers=1, device="cpu")
    siren_bf16 = fused_mlp.make_fused_sdf_fn(siren, precision="bf16")
    assert isinstance(siren_bf16, fused_mlp.FusedSirenSDF)
    assert siren_bf16.precision == "bf16"
    assert siren_bf16.fused_ray_sampler.packing_stride == 2
    with pytest.raises(ValueError):
        fused_mlp.make_fused_sdf_fn(siren, precision="f16")
    sdf = fused_mlp.make_fused_sdf_fn(tfield, precision="bf16")
    assert sdf.fused_ray_sampler.packing_stride == 2
    assert fused_mlp.make_fused_sdf_fn(tfield).fused_ray_sampler.packing_stride == 3
    x = torch.from_numpy(_points((40, 3))).requires_grad_(True)
    assert not sdf(x).requires_grad
    sdf.sdf_and_grad(x)
    assert fused_mlp.IGR_KERNEL.launches == 0
    with pytest.raises(TypeError):
        sdf(x.detach().double())


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round float32 to tf32 with ties away from zero: add half an ulp of
    the 10-bit mantissa to the bits and clear the low 13."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a: torch.Tensor):
    hi = _tf32(a.numpy())
    return torch.from_numpy(hi), torch.from_numpy(_tf32(a.numpy() - hi))


def _mm3(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor) -> torch.Tensor:
    """a (N, K) @ W (out, K)^T as the kernel's f32 mode forms it."""
    a_hi, a_lo = _split(a)
    return a_lo @ w_hi.t() + a_hi @ w_lo.t() + a_hi @ w_hi.t()


def _tf32x3_model(pack, x):
    """The f32 mode of the fused IGR kernel (csrc/mlp_mma.cuh) on its
    tensor-core pack: first layer and head in float32, hidden products of
    values and tangent rows in 3xTF32, the skip as the kernel writes it."""
    (w0, b0, wh, wh_lo, bh, wout, bout), _ = pack.mma_net(False)
    hidden, n_hidden, skip, final_tanh = pack.arch_args()
    c = torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32)
    eye = torch.eye(3).expand(x.shape[0], 3, 3)

    def store(h, jac, layer):
        if skip >> layer & 1:
            h = torch.cat([h[:, :hidden - 3], x], -1) * c
            jac = torch.cat([jac[..., :hidden - 3], eye], -1) * c
        return h, jac

    def act(z, jz):
        return tf.softplus_beta(z), torch.sigmoid(100.0 * z)[:, None, :] * jz

    h, jac = store(*act(x @ w0.t() + b0, w0.t().expand(x.shape[0], 3, hidden)), 1)
    for l in range(n_hidden):
        z = _mm3(h, wh[l], wh_lo[l]) + bh[l]
        jz = _mm3(jac.reshape(-1, hidden), wh[l], wh_lo[l]).reshape(jac.shape)
        h, jac = store(*act(z, jz), l + 2)
    out, g = h @ wout + bout, jac @ wout
    if final_tanh:
        t = torch.tanh(out)
        out, g = t, (1.0 - t * t)[:, None] * g
    return out, g


@pytest.fixture(scope="module")
def fitted256():
    """The bench field (4×256, skip at the head) fitted to the r = 0.6
    sphere at a CPU-sized batch, and 4096 points in [−1.2, 1.2]³."""
    from isopoints_torch import bench
    field, mse = bench.fit_sphere_field("cpu", n_steps=300, n_points=1024)
    assert mse < 1e-2 and field.skip_in == (4,)
    x = torch.from_numpy(_points((4096, 3), seed=9, scale=1.2))
    return fused_mlp.IgrPack(field), x


def test_tf32x3_emulation_holds_a_tenth_of_the_f32_tolerance(fitted256):
    pack, x = fitted256
    v, g = _tf32x3_model(pack, x)
    v_ref = fused_mlp.igr_sdf_plain(pack, x)
    v_ref2, g_ref = fused_mlp.igr_sdf_and_grad_plain(pack, x)
    np.testing.assert_allclose(v.numpy(), v_ref.numpy(), atol=2e-6, rtol=0)
    np.testing.assert_allclose(v.numpy(), v_ref2.numpy(), atol=2e-6, rtol=0)
    scale = max(1.0, float(g_ref.abs().max()))
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), atol=1e-5 * scale, rtol=0)
    # and the split is doing the work: one tf32 pass is far outside
    (w0, b0, wh, wh_lo, bh, wout, bout), _ = pack.mma_net(False)
    one = _split(x @ w0.t())[0]
    assert float((one - x @ w0.t()).abs().max()) > 1e-5


@pytest.mark.parametrize("bf16", [False, True])
def test_mma_pack_layout(fitted256, bf16):
    """The tensor-core pack: hidden layers (L, H, H) as (out, in), padded;
    bf16 values in the bf16 mode, the tf32 hi/lo split in f32."""
    pack, _ = fitted256
    (w0, b0, wh, wh_lo, bh, wout, bout), ptrs = pack.mma_net(bf16)
    ws = pack.ws_bf16 if bf16 else pack.ws
    assert wh.shape == (3, 256, 256) and bh.shape == (3, 256)
    full = torch.stack([ws[1], ws[2], torch.nn.functional.pad(ws[3], (0, 0, 0, 3))])
    if bf16:
        assert wh.dtype == torch.bfloat16 and wh_lo is None and ptrs[3] is None
        assert torch.equal(wh.float(), full)
    else:
        hi, lo = _split(full)
        assert torch.equal(wh, hi) and torch.equal(wh_lo, lo)
        assert float(((wh + wh_lo) - full).abs().max()) <= 2.0 ** -22 * float(full.abs().max())
    assert torch.equal(w0[:, :3], ws[0]) and torch.equal(wout, ws[-1].reshape(-1))
    # the pointers are the kept tensors', one pack per mode
    tensors = pack.mma_net(bf16)[0]
    assert ptrs == [None if t is None else t.data_ptr() for t in tensors]
    assert pack.mma_net(bf16)[1] is ptrs
