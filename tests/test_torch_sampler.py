"""Port parity: the fused dense ray sampler (ops/fused_sampler.py) on the
CPU, which is its plain twin, against the JAX Pallas sampler kernel in
interpret mode (`precision="highest"`), for the SIREN and the IGR field,
each also with the coarse sweep; and a model of the kernel's block
schedule against the plain version.

Tolerances: the picked depths `t_pick` and `t_min` must be equal (they are
proposal depths formed by the same float32 arithmetic, and the pick is an
argmin). `f_pick` and `z_secant` use atol 1e-5: float32 round-off of two
MLP summation orders, and the secant divides by value differences. IGR:
the field is flat where a ray passes closest, so two steps' values may tie
within round-off and the packages' f-argmins pick either step: t_min is
equal on all but 2% of rays, and there the port's field gives both depths
values within 1e-6. The IGR coarse sweep exists in JAX only in its f32x3
packing, whose fine evals are held to plain f32 at 2e-5, so the coarse
case holds `f_pick` to 2e-5 and `z_secant` to 1e-4 (the root moves by the
value's error over the field's slope along the ray). The SIREN coarse
sweep likewise (JAX's f32x3 packing, margin 2e-3): picks and t_min equal,
f_pick within 2e-5, and z_secant within 1e-4 or within 2e-5 over the
field's slope along the ray |df/dz| at JAX's root (phase 7 of
chip_smoke.py holds the kernel so): a grazing ray's root moves by the
fine fields' difference over its slope (measured 4.4e-4 at slope 0.038 on
another seed of these rays, |dz|·slope 1.7e-5).

The block schedule (csrc/fused_sampler.cu, both fields): R rays a block, each
128-row sweep tile holding 128 / R steps of every ray, masked rows at the
origin, the pick folded tile by tile, then the re-validation and secant
tiles. Modelled in PyTorch on an elementwise field (a row's value cannot
depend on the rows beside it, as on the tensor-core tile), with tied
values, NaN and empty intervals, it equals `sweep_plain` bit for bit; and
on a SIREN field (f32 fine, bf16 coarse, each point evaluated alone) at the
rays a block `rays_per_block` chooses.

A compacted buffer (`filled`: the first filled[b] slots of row b hold
rays): `sweep_plain` and the fused callable's CPU route give the slots
past a row's count zeros and every other slot what the call without
`filled` gives, bit for bit; `rays_per_block` on a buffer's row counts
tiles each row apart.
"""

import math

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
from isopoints_torch.utils import eps_denom, fma, linspace01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _nan_step(steps: np.ndarray) -> np.ndarray:
    """`steps` with step 5 NaN: a NaN proposal on every ray, which neither
    argmin may pick, and a NaN bracket end where step 6 is picked."""
    steps = steps.copy()
    steps[5] = np.nan
    return steps


@pytest.mark.parametrize("kind,n_secant", [("linspace", 8), ("random", 0),
                                           ("linspace", 0), ("nan", 8)])
def test_sampler_matches_jax(samplers, kind, n_secant):
    j_sampler, sdf = samplers
    arrays = _rays()
    steps = (np.random.RandomState(5).uniform(0, 1, 16).astype(np.float32)
             if kind == "random" else linspace01(16).numpy())
    if kind == "nan":
        steps = _nan_step(steps)
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
    """On the CPU the sampler is `sweep_plain` over the callable's plain
    values, the coarse sweep over the plain bf16 values; no launch."""
    _, sdf = samplers
    cam, dirs, t_lo, t_hi = (torch.from_numpy(a) for a in _rays(32))
    sdf.fused_ray_sampler(cam, dirs, t_lo, t_hi, linspace01(8))
    out = sdf.fused_ray_sampler(cam, dirs, t_lo, t_hi, linspace01(8),
                                margin=2e-3, coarse_sweep=True)
    pack = sdf.pack
    ref = fused_sampler.sweep_plain(
        lambda p: fused_mlp.siren_sdf_plain(pack, p.reshape(-1, 3)).reshape(p.shape[:-1]),
        cam, dirs, t_lo, t_hi, linspace01(8), 8, 2e-3,
        sdf_fn_coarse=lambda p: fused_mlp.siren_sdf_plain(
            pack, p.reshape(-1, 3), True).reshape(p.shape[:-1]))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_sampler.KERNEL.launches == 0


@pytest.fixture(scope="module")
def siren_x3_sampler():
    """JAX's SIREN Pallas sampler in its default f32x3 packing, whose
    coarse sweep is the bf16 mode of the same weights."""
    jfield = JSiren(hidden_size=64, n_layers=2)
    params = jfield.init(jax.random.key(0))
    return jax_fused(jfield, params, interpret=True)[0].fused_ray_sampler


@pytest.mark.parametrize("nan", [False, True])
def test_siren_coarse_sampler_matches_jax(samplers, siren_x3_sampler, nan):
    _, sdf = samplers
    arrays = _rays()
    steps = linspace01(24).numpy()
    if nan:
        steps = _nan_step(steps)
    kw = dict(n_secant=8, margin=2e-3, coarse_sweep=True)
    ref = siren_x3_sampler(*(jnp.asarray(a) for a in arrays), jnp.asarray(steps), **kw)
    out = sdf.fused_ray_sampler(*(torch.from_numpy(a) for a in arrays),
                                torch.from_numpy(steps), **kw)
    t_pick, f_pick, t_min, z_sec = (o.numpy() for o in out)
    r_pick, r_f, r_min, r_sec = (np.asarray(o) for o in ref)
    np.testing.assert_array_equal(t_pick, r_pick)
    np.testing.assert_array_equal(t_min, r_min)
    np.testing.assert_allclose(f_pick, r_f, atol=2e-5)
    crossing = r_f < 0
    assert crossing.sum() > 10
    cam, dirs = (torch.from_numpy(a) for a in arrays[:2])
    _, g = sdf.sdf_and_grad(fma(torch.from_numpy(r_sec)[..., None], dirs, cam))
    slope = (g * dirs).sum(-1).abs().numpy()
    dz = np.abs(z_sec - r_sec)
    ok = (dz <= 1e-4) | (dz * slope <= 2e-5) | (np.isnan(z_sec) & np.isnan(r_sec))
    assert ok[crossing].all(), (dz[crossing].max(), (dz * slope)[crossing].max())
    if nan:   # a NaN step before the pick makes a NaN bracket on some rays
        assert np.isnan(r_sec[crossing]).any()


# ---------------------------------------------------------------------------
# IGR: the plain version against JAX's IGR Pallas sampler, and a model of
# the IGR kernel's block schedule
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def igr_samplers():
    """The 4-layer IGR field at width 64 (skip at layer 4) in both
    packages: JAX's Pallas sampler in interpret mode at `highest` (fine
    sweep) and `f32x3` (its coarse sweep is the bf16 mode), and the port's
    fused callable, whose CPU sampler is `sweep_plain`."""
    from isopoints_tpu.models.fields import SDFField as JSDF
    from isopoints_tpu.ops.pallas_mlp import make_fused_igr_sdf as jax_igr
    from isopoints_torch.models.fields import SDFField
    jfield = JSDF(hidden_size=64, n_layers=4, num_frequencies=0)
    params = jfield.init(jax.random.key(0))
    j_fine, _ = jax_igr(jfield, params, interpret=True, precision="highest")
    j_x3, _ = jax_igr(jfield, params, interpret=True)
    tfield = SDFField(hidden_size=64, n_layers=4, num_frequencies=0,
                      device="cpu")
    sd = params_from_jax({"decoder": jax.tree.map(np.asarray, params)},
                         keep_weight_norm=True)
    tfield.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return ({False: j_fine.fused_ray_sampler, True: j_x3.fused_ray_sampler},
            fused_mlp.make_fused_igr_sdf(tfield))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("coarse", [False, True])
def test_igr_sampler_matches_jax(igr_samplers, coarse, nan):
    j_samplers, sdf = igr_samplers
    arrays = _rays()
    steps = linspace01(24).numpy()
    if nan:
        steps = _nan_step(steps)
    margin = 2e-3 if coarse else 0.0
    ref = j_samplers[coarse](*(jnp.asarray(a) for a in arrays),
                             jnp.asarray(steps), n_secant=8, margin=margin,
                             coarse_sweep=coarse)
    out = sdf.fused_ray_sampler(*(torch.from_numpy(a) for a in arrays),
                                torch.from_numpy(steps), n_secant=8,
                                margin=margin, coarse_sweep=coarse)
    t_pick, f_pick, t_min, z_sec = (o.numpy() for o in out)
    r_pick, r_f, r_min, r_sec = (np.asarray(o) for o in ref)
    np.testing.assert_array_equal(t_pick, r_pick)
    # JAX has its coarse sweep only in the f32x3 packing, whose fine evals
    # (the re-validation and the secant) are a 3 x bf16 split that answers
    # to plain f32 at 2e-5 (ops/pallas_mlp.py:34-44), not at 1e-5; the
    # secant's root moves by that over the field's slope along the ray
    f_tol, z_tol = (2e-5, 1e-4) if coarse else (1e-5, 1e-5)
    np.testing.assert_allclose(f_pick, r_f, atol=f_tol)
    crossing = r_f < 0
    assert crossing.sum() > 10
    np.testing.assert_allclose(z_sec[crossing], r_sec[crossing], atol=z_tol)
    # t_min equal, but for a near-tie: the IGR field is flat at a ray's
    # closest approach, so two steps' values may lie within float32
    # round-off of each other and the two packages' sums pick either; then
    # the port's field takes both depths to values within 1e-6
    cam, dirs = (torch.from_numpy(a) for a in arrays[:2])
    moved = t_min != r_min
    assert moved.mean() <= 0.02
    f_at = lambda t: sdf(fma(torch.from_numpy(t)[..., None], dirs, cam)).numpy()
    np.testing.assert_allclose(f_at(t_min)[moved], f_at(r_min)[moved], atol=1e-6)


def _field(p: torch.Tensor, levels: float) -> torch.Tensor:
    """An elementwise SDF: the r = 0.9 sphere quantised to 1/levels (ties
    along a ray, exact zeros), NaN in the slab 0.15 < x < 0.25."""
    x, y, z = p.unbind(-1)
    f = torch.round((torch.sqrt(x * x + y * y + z * z) - 0.9) * levels) / levels
    return torch.where((x > 0.15) & (x < 0.25), float("nan"), f)


def _igr_schedule(fine, coarse, cam, dirs, t_lo, t_hi, steps, n_secant,
                  margin, rays, rows=128):
    """The IGR sampler kernel's block schedule (csrc/fused_sampler.cu
    `igr_sweep`) in PyTorch: `rays` rays a block, each `rows`-row sweep
    tile holding rows / rays steps of every ray (row j * rays + r), masked
    rows at the origin, each ray's pick folded in step order after every
    tile; then the re-validation tiles (rows r: z_low, rays + r: t_pick) and
    one tile set per secant step, `rows` rows each (128; 64 on the wide
    tile's unit of two blocks)."""
    n, n_steps = dirs.shape[0], steps.shape[0]
    per_tile = rows // rays
    outs = [torch.empty(n) for _ in range(4)]
    isnan, where = torch.isnan, torch.where
    for r0 in range(0, n, rays):
        nr = min(rays, n - r0)
        c, d = torch.zeros(rays, 3), torch.zeros(rays, 3)
        lo, hi = torch.zeros(rays), torch.zeros(rays)
        c[:nr], d[:nr] = cam[r0:r0 + nr], dirs[r0:r0 + nr]
        lo[:nr], hi[:nr] = t_lo[r0:r0 + nr], t_hi[r0:r0 + nr]
        span = hi - lo
        inf, zero = torch.full((rays,), math.inf), torch.zeros(rays)
        best, t_pick, f_pick, z_low, f_low = inf, zero, zero, zero, zero
        prev_t, prev_f, f_min, t_min = zero, zero, inf, zero
        sweep_fn = coarse or fine
        for it in range((n_steps + per_tile - 1) // per_tile):
            s = it * per_tile + torch.arange(rows) // rays
            r = torch.arange(rows) % rays
            ok = (s < n_steps) & (r < nr)
            t = fma(steps[s.clamp(max=n_steps - 1)], span[r], lo[r])
            vals = sweep_fn(torch.where(ok[:, None], fma(t[:, None], d[r], c[r]), 0.0))
            v_m = vals + margin
            # the fold: thread r takes its ray's steps of the tile in order
            for j in range(per_tile):
                si = it * per_tile + j
                if si >= n_steps:
                    break
                ts, fs, v = (a[j * rays:(j + 1) * rays] for a in (t, vals, v_m))
                sgn = (v > 0).float() - (v < 0).float()
                cost = where(isnan(v), v, sgn * float(n_steps - si))
                pt, pf = (ts, fs) if si == 0 else (prev_t, prev_f)
                upd = cost < best            # False at NaN: a NaN step never wins
                best, t_pick, f_pick = (where(upd, a, b) for a, b in
                                        ((cost, best), (ts, t_pick), (fs, f_pick)))
                z_low, f_low = where(upd, pt, z_low), where(upd, pf, f_low)
                upd = fs < f_min
                f_min, t_min = where(upd, fs, f_min), where(upd, ts, t_min)
                prev_t, prev_f = ts, fs
        if coarse is not None:   # the re-validation tiles
            z2 = torch.cat([z_low, t_pick])
            f2 = torch.cat([fine(fma(z2[q:q + rows, None], d.repeat(2, 1)[q:q + rows],
                                     c.repeat(2, 1)[q:q + rows]))
                            for q in range(0, 2 * rays, rows)])
            f_low, f_pick = f2[:rays], f2[rays:]
        fl, fh, zl, zh = f_low, f_pick, z_low, t_pick
        for _ in range(n_secant):
            z = -fl * (zh - zl) / eps_denom(fh - fl, 1e-12) + zl
            f_mid = torch.cat([fine(fma(z[q:q + rows, None], d[q:q + rows],
                                        c[q:q + rows]))
                               for q in range(0, rays, rows)])
            low, high = f_mid > 0, f_mid < 0
            fl, zl = torch.where(low, f_mid, fl), torch.where(low, z, zl)
            fh, zh = torch.where(high, f_mid, fh), torch.where(high, z, zh)
        z_sec = -fl * (zh - zl) / eps_denom(fh - fl, 1e-12) + zl
        for o, v in zip(outs, (t_pick, f_pick, t_min, z_sec)):
            o[r0:r0 + nr] = v[:nr]
    return outs


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("margin", [0.0, 2e-3])
@pytest.mark.parametrize("rays,n_rays,n_steps,n_secant", [
    (64, 150, 37, 8),     # 2 steps a tile, the last tile half masked; 22 rays
    (32, 70, 100, 8),     # 4 steps a tile; a ragged last block of 6 rays
    (128, 130, 5, 0),     # 1 step a tile, 2 re-validation tiles, no secant
])
def test_igr_block_schedule_matches_plain(rays, n_rays, n_steps, n_secant,
                                          margin, coarse):
    # rays 0..6 have empty intervals (t_hi = t_lo)
    cam, dirs, t_lo, t_hi = (torch.from_numpy(a[0]) for a in _rays(n_rays, seed=3))
    steps = linspace01(n_steps)
    fine = lambda p: _field(p, 256.0)
    crs = (lambda p: _field(p, 64.0)) if coarse else None
    ref = fused_sampler.sweep_plain(fine, cam, dirs, t_lo, t_hi, steps,
                                    n_secant, margin, sdf_fn_coarse=crs)
    out = _igr_schedule(fine, crs, cam, dirs, t_lo, t_hi, steps, n_secant,
                        margin, rays)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # the cases the fold must get right are there
    ts = fma(steps, (t_hi - t_lo)[:, None], t_lo[:, None])
    vals = (coarse and crs or fine)(fma(ts[..., None], dirs[:, None], cam[:, None]))
    # rays with a NaN step before the pick: a fold that let NaN win differs
    nan_first = (torch.isnan(vals) & (ts < ref[0][:, None])).any(-1)
    assert int(nan_first.sum()) >= 3
    ties = (vals[:, 1:] == vals[:, :-1]).any(-1)[7:]   # past the empty rays
    assert int(ties.sum()) >= 3 and bool((vals == 0).any())
    assert int((ref[1] < 0).sum()) > 10


def test_rays_per_block():
    """The fewest tile rounds on the busiest SM (waves × tiles a block),
    the larger block on a tie: the bench trace's 24,576-ray coarse buffer
    keeps 64 rays a block (384 blocks on 132 SMs, the measured best), a
    training step's 2048 rays x (100 + 8) take 16 (128 blocks, 21 tiles
    each) and 1024 rays take 8 (128 blocks, 15 tiles each)."""
    rpb = fused_sampler.rays_per_block
    assert rpb(24_576, 100, 8, True, 132) == 64
    assert rpb(2048, 100, 8, False, 132) == 16
    assert rpb(2048, 100, 8, True, 132) == 16
    assert rpb(1024, 100, 8, True, 132) == 8
    assert rpb(0, 100, 8, False, 132) == 8 and rpb(1, 5, 0, False, 132) == 16
    for n in (1, 100, 1000, 5000, 30_000):
        for steps, sec in ((100, 8), (16, 0), (1000, 8)):
            r = rpb(n, steps, sec, False, 132)
            assert r in (8, 16, 32, 64) and 128 % r == 0


@pytest.mark.parametrize("filled", [(0, 1, 13, 40), (40, 0, 0, 2)])
@pytest.mark.parametrize("coarse", [False, True])
def test_sweep_plain_on_filled_rows(samplers, filled, coarse):
    """Rows of 40 slots filled 0, 1, 13 and 40 (and a whole row beside
    empty ones), on the elementwise field and through the SIREN callable's
    CPU route: the filled slots equal the sweep of every slot, the others
    read zeros, and `swept` counts every slot (the plain sweep computes
    them all)."""
    cam, dirs, t_lo, t_hi = (torch.from_numpy(a[0]).reshape(4, 40, -1).squeeze(-1)
                             for a in _rays(160, seed=6))
    steps = linspace01(24)
    counts = torch.tensor(filled, dtype=torch.int32)
    keep = torch.arange(40)[None, :] < counts[:, None]
    margin = 2e-3 if coarse else 0.0
    crs = (lambda p: _field(p, 64.0)) if coarse else None
    fine = lambda p: _field(p, 256.0)
    whole = fused_sampler.sweep_plain(fine, cam, dirs, t_lo, t_hi, steps, 8,
                                      margin, sdf_fn_coarse=crs)
    rows = fused_sampler.sweep_plain(fine, cam, dirs, t_lo, t_hi, steps, 8,
                                     margin, sdf_fn_coarse=crs, filled=counts)
    for a, b in zip(rows, whole):
        assert a.shape == (4, 40)
        torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0, equal_nan=True)
        assert not bool(a[~keep].any())
    _, sdf = samplers
    kw = dict(n_secant=8, margin=margin, coarse_sweep=coarse)
    swept = torch.zeros((), dtype=torch.int32)
    got = sdf.fused_ray_sampler(cam, dirs, t_lo, t_hi, steps, filled=counts,
                                swept=swept, **kw)
    want = sdf.fused_ray_sampler(cam, dirs, t_lo, t_hi, steps, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a[keep], b[keep], rtol=0, atol=0, equal_nan=True)
        assert not bool(a[~keep].any())
    assert int(swept) == 160 and int((want[1][keep] < 0).sum()) > 0
    with pytest.raises(ValueError, match="filled"):
        sdf.fused_ray_sampler(cam, dirs, t_lo, t_hi, steps, filled=counts[:3], **kw)


@pytest.mark.parametrize("counts,units,rows,rays", [
    # a render chunk's IGR sampler buffer: 4 rows of ~950 filled slots of
    # 8192, 66 units of two SMs (64-row tiles): 30 tiles a row, 2 rounds
    ((953, 940, 1210, 877), 66, 64, 32),
    # a SIREN chunk's: 2 rows of ~820 of 8192 on 132 SMs: 16 rays a tile
    # fill 104 of them in one round; 64 would run 26 blocks of 59 tiles
    ((820, 845), 132, 128, 16),
    # rows apart: 2112 rays in one row fill the 132 SMs once at 16 rays a
    # tile (22 tiles each), in 264 rows of 8 a tile of 16 holds 8 of them
    ((2112,), 132, 128, 16),
    ((8,) * 264, 132, 128, 8),
])
def test_rays_per_block_on_filled_rows(counts, units, rows, rays):
    sms = 128 // rows
    assert fused_sampler.rays_per_block(counts, 100, 8, True, units * sms,
                                        rows, sms) == rays


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("rays,n_rays,n_steps,n_secant", [
    (32, 75, 37, 8),      # 2 steps a 64-row tile, the last tile half masked; 11 rays
    (16, 40, 100, 8),     # 4 steps a tile; a ragged last unit of 8 rays
    (8, 9, 5, 0),         # 8 steps a tile, one sweep tile, no secant
])
def test_wide_unit_schedule_matches_plain(rays, n_rays, n_steps, n_secant,
                                          coarse):
    """The sampler's schedule on the wide tile (csrc/fused_sampler.cu's
    wide kernel: a unit of two blocks, 64-row tiles, at most 32 rays; the
    f32 re-validation and secant tiles on the same 64 rows) equals
    `sweep_plain` bit for bit, ties, NaN and empty intervals included."""
    cam, dirs, t_lo, t_hi = (torch.from_numpy(a[0]) for a in _rays(n_rays, seed=4))
    steps = linspace01(n_steps)
    fine = lambda p: _field(p, 256.0)
    crs = (lambda p: _field(p, 64.0)) if coarse else None
    margin = 2e-3 if coarse else 0.0
    ref = fused_sampler.sweep_plain(fine, cam, dirs, t_lo, t_hi, steps,
                                    n_secant, margin, sdf_fn_coarse=crs)
    out = _igr_schedule(fine, crs, cam, dirs, t_lo, t_hi, steps, n_secant,
                        margin, rays, rows=64)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert 2 * rays <= 64


def _one_by_one(fn):
    """`fn` on each point alone: a row's value does not depend on the rows
    beside it, as on the kernel's tensor-core tile."""
    def run(p):
        flat = p.reshape(-1, 3)
        return torch.cat([fn(flat[i:i + 1]) for i in range(flat.shape[0])]
                         ).reshape(p.shape[:-1])
    return run


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("n_rays,n_sms,n_steps,rays", [
    (40, 132, 20, 8),     # 16 steps a tile
    (150, 16, 9, 16),     # 8 steps a tile; a ragged last block
    (300, 16, 5, 32),     # 4 steps a tile, two sweep tiles
])
def test_siren_block_schedule_matches_plain(samplers, n_rays, n_sms, n_steps,
                                            rays, coarse):
    """The SIREN sampler's block schedule at the rays a block the wrapper
    chooses for `n_rays` on `n_sms` SMs, on the f32 field (and its bf16
    sweep under `coarse`), equals `sweep_plain` bit for bit."""
    _, sdf = samplers
    assert fused_sampler.rays_per_block(n_rays, n_steps, 4, coarse, n_sms) == rays
    cam, dirs, t_lo, t_hi = (torch.from_numpy(a[0]) for a in _rays(n_rays, seed=5))
    steps = linspace01(n_steps)
    pack = sdf.pack
    fine = _one_by_one(lambda p: fused_mlp.siren_sdf_plain(pack, p))
    crs = (_one_by_one(lambda p: fused_mlp.siren_sdf_plain(pack, p, True))
           if coarse else None)
    margin = 2e-3 if coarse else 0.0
    ref = fused_sampler.sweep_plain(fine, cam, dirs, t_lo, t_hi, steps, 4,
                                    margin, sdf_fn_coarse=crs)
    out = _igr_schedule(fine, crs, cam, dirs, t_lo, t_hi, steps, 4, margin, rays)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert int((ref[1] < 0).sum()) > 5
