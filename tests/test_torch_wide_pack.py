"""The wide MLP tile's host side (csrc/mlp_wide.cuh, the instances at 384
and 512): the stage pack `fused_mlp.wide_layout` of the IGR and SIREN
packs, and the sampler's rays a unit.

- Unpacked, the pack gives back the padded hidden layers bit for bit (the tf32
  hi and lo parts, or the bf16 values), a skip layer's point columns
  included at Hk-3..Hk-1, and the launchers' pointers carry the pack in
  wh's place.
- A reader of the pack that addresses it as the kernel does (a block's
  stream [layer][column half][stage], each warpgroup's wgmma operand by
  its descriptor: 8-row core matrices of 16 bytes, LBO 128 bytes between
  the K halves, SBO between row groups, the lo part at half a stage)
  assembles every layer's weights bit for bit, so the descriptors the
  kernel builds read the weights the plain version multiplies by.
- `rays_per_block` at the wide tile's shape (64 rows, a unit of two
  blocks on two SMs): at most 32 rays, the fewest rounds.
"""

import numpy as np
import pytest
import torch

from isopoints_torch.models import fields as tf
from isopoints_torch.ops import _build, fused_mlp, fused_sampler


def _unlayout(pack, n_layers, h, bf16):
    """`fused_mlp.wide_layout`'s inverse: (wh, wh_lo) of (n_layers, h, h)
    as (out, in), wh_lo None in bf16."""
    nb = h // 2
    if bf16:
        w = pack.view(torch.int16).reshape(n_layers, 2, h // 32, nb // 8, 4, 8, 8)
        return w.permute(0, 1, 3, 5, 2, 4, 6).reshape(n_layers, h, h).view(torch.bfloat16), None
    w = pack.view(torch.int32).reshape(n_layers, 2, h // 8, 2, nb // 8, 2, 8, 4)
    w = w.permute(3, 0, 1, 4, 6, 2, 5, 7).reshape(2, n_layers, h, h).view(torch.float32)
    return w[0], w[1]


def _igr(hidden, n_layers, skip, seed=0):
    torch.manual_seed(seed)
    return fused_mlp.IgrPack(tf.SDFField(hidden_size=hidden, n_layers=n_layers,
                                         num_frequencies=0, skip_in=skip,
                                         device="cpu"))


def _siren(hidden, n_layers, seed=0):
    torch.manual_seed(seed)
    return fused_mlp.SirenPack(tf.SirenField(hidden_size=hidden, n_layers=n_layers,
                                             device="cpu"))


def _stage_reader(pack, n_layers, h, bf16):
    """The weights as the wide kernel reads them, (L, h, h) (out, in) in
    bf16 or the f32 (hi, lo): for every layer, column half cb, stage kc and
    consumer warpgroup wg, the operand at the descriptor's start read core
    matrix by core matrix (mlp_wide.cuh `layer_mma`, `desc`)."""
    raw = pack.numpy()
    nb, nw = h // 2, h // 4
    sb = nb * 64                                  # stage bytes
    kc_n = h // 32 if bf16 else h // 8            # stages a layer
    sbo, lbo = (512 if bf16 else 256), 128
    esz = 2 if bf16 else 4
    parts = 1 if bf16 else 2
    out = np.zeros((parts, n_layers, h, h), dtype=np.uint16 if bf16 else np.uint32)
    n = np.arange(nw)[:, None]
    for l in range(n_layers):
        for cb in range(2):
            for kc in range(kc_n):
                stage = ((l * 2 + cb) * kc_n + kc) * sb
                for wg in range(2):
                    start = stage + wg * (nw // 8) * sbo
                    for part in range(parts):
                        base = start + part * (sb // 2)
                        k_steps = 2 if bf16 else 1       # 32-byte k-steps a stage
                        for j in range(k_steps):
                            kb = np.arange(32)[None, :]  # byte of K in the k-step
                            off = (base + j * 256 + (n // 8) * sbo + (kb // 16) * lbo
                                   + (n % 8) * 16 + kb % 16)
                            b = raw[off].reshape(nw, 32 // esz, esz)
                            vals = b.copy().view(np.uint16 if bf16 else np.uint32)[..., 0]
                            k0 = kc * 32 + j * 16 if bf16 else kc * 8
                            rows = cb * nb + wg * nw + np.arange(nw)
                            out[part, l][rows[:, None], k0 + np.arange(32 // esz)[None, :]] = vals
    if bf16:
        return torch.from_numpy(out[0].view(np.int16)).view(torch.bfloat16), None
    f = torch.from_numpy(out.view(np.float32))
    return f[0], f[1]


@pytest.mark.parametrize("hidden,n_layers,skip", [(300, 4, (2,)), (384, 3, (1,)),
                                                  (512, 4, (3,))])
@pytest.mark.parametrize("bf16", [False, True])
def test_igr_wide_pack_round_trip(hidden, n_layers, skip, bf16):
    """The IGR pack's wide stage pack unpacks to its padded hidden layers,
    the skip layer's point columns at Hk-3..Hk-1, and the pointers carry
    it in wh's place (wh_lo None)."""
    pack = _igr(hidden, n_layers, skip)
    hk = fused_mlp.kernel_width(hidden)
    assert hk > _build.NARROW_MAX
    tensors, ptrs = pack.mma_net(bf16)
    wh, wh_lo = tensors[2], tensors[3]
    wide = pack._wide[bf16]
    assert wide.dtype == torch.uint8 and wide.numel() == wh.numel() * (2 if bf16 else 8)
    assert ptrs[2] == wide.data_ptr() and ptrs[3] is None
    hi, lo = _unlayout(wide, wh.shape[0], hk, bf16)
    assert torch.equal(hi.view(torch.int16 if bf16 else torch.int32),
                       wh.view(torch.int16 if bf16 else torch.int32))
    assert (lo is None) == bf16 and (bf16 or torch.equal(lo, wh_lo))
    ws = pack.ws_bf16 if bf16 else pack.ws
    for l in range(1, pack.n_layers - 1):     # hidden layer l-1 of the tile
        want = ws[l]
        split = hidden - 3 if l in skip else hidden
        got = hi[l - 1].float() if bf16 else hi[l - 1] + lo[l - 1]
        rows = min(want.shape[0], hk)
        assert torch.allclose(got[:rows, :split], want[:, :split], rtol=0,
                              atol=2.0 ** -21 * float(want.abs().max()))
        assert torch.allclose(got[:rows, hk - (hidden - split):], want[:, split:],
                              rtol=0, atol=2.0 ** -21 * float(want.abs().max()))
        assert not got[:, split:hk - (hidden - split)].any()


@pytest.mark.parametrize("hidden,n_layers", [(320, 2), (512, 3)])
@pytest.mark.parametrize("bf16", [False, True])
def test_siren_wide_pack_round_trip(hidden, n_layers, bf16):
    """The SIREN pack likewise (no skip), args carrying the pack."""
    pack = _siren(hidden, n_layers)
    hk = fused_mlp.kernel_width(hidden)
    tensors, args = pack.mma_net(bf16)
    wide = pack._wide[bf16]
    assert args[2] == wide.data_ptr() and args[3] is None and args[7] == hk
    hi, lo = _unlayout(wide, n_layers, hk, bf16)
    assert torch.equal(hi.float(), tensors[2].float())
    assert bf16 or torch.equal(lo, tensors[3])


@pytest.mark.parametrize("hk", [384, 512])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_pack_read_as_the_kernel_reads_it(hk, bf16):
    """The kernel's stage and descriptor addressing over `wide_layout`
    assembles the layers bit for bit (hi and lo in f32)."""
    g = torch.Generator().manual_seed(hk)
    w = torch.randn((2, hk, hk), generator=g)
    hi, lo = (w.to(torch.bfloat16), None) if bf16 else fused_mlp.tf32_split(w)
    got_hi, got_lo = _stage_reader(fused_mlp.wide_layout(hi, lo), 2, hk, bf16)
    assert torch.equal(got_hi.view(torch.int16 if bf16 else torch.int32),
                       hi.view(torch.int16 if bf16 else torch.int32))
    assert bf16 or torch.equal(got_lo, lo)


def test_narrow_packs_keep_their_pointers():
    """Up to 256 the pointers stay the (L, H, H) tensors' and no stage pack
    is made."""
    pack = _igr(256, 4, (2,))
    for bf16 in (False, True):
        tensors, ptrs = pack.mma_net(bf16)
        assert ptrs == [None if t is None else t.data_ptr() for t in tensors]
        assert pack._wide[bf16] is None


def test_rays_per_block_wide():
    """At the wide tile's shape (64 rows, two SMs a unit) the rays a unit
    are at most 32, the fewest tile rounds: the bench trace's 24,576-ray
    coarse buffer and a training step's 2048 rays take 32 (768 and 64
    units), 1024 rays take 16 (64 units of 25 + 9 tiles against 32 units
    of 50 + 9); one ray of 5 steps takes 8 (one sweep tile)."""
    assert fused_sampler.tile_shape(512) == (64, 2)
    assert fused_sampler.tile_shape(384) == (64, 2)
    assert fused_sampler.tile_shape(256) == (128, 1)
    rpb = lambda n, s, sec, c: fused_sampler.rays_per_block(n, s, sec, c, 132, 64, 2)
    assert rpb(24_576, 100, 8, True) == 32
    assert rpb(2048, 100, 8, True) == 32
    assert rpb(1024, 100, 8, True) == 16
    assert rpb(1, 5, 0, False) == 8 and rpb(0, 100, 8, False) == 8
    for n in (1, 100, 1000, 5000, 30_000):
        for steps, sec in ((100, 8), (16, 0), (1000, 8)):
            r = rpb(n, steps, sec, False)
            assert r in (8, 16, 32) and 64 % r == 0
