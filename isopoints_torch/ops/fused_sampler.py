"""Fused dense ray sampler: a hand-written CUDA kernel and its plain version.

Replaces `make_sampler` / `_sweep_kernel` of
isopoints_tpu/ops/pallas_sampler.py (:52, :129). The kernel
(csrc/fused_sampler.cu) evaluates the n_steps proposals of a block's rays
as MLP tiles, picks the first sign change (the first minimum of
sign(f + margin)·countdown), the bracket and the f-argmin, and runs the
fixed secant, all without writing a (rays × n_steps) array to device
memory. For the SIREN and the IGR field alike it evaluates on the fused
MLP kernels' tensor-core tile (csrc/mlp_mma.cuh, 128 rows, up to width 256;
above, csrc/mlp_wide.cuh's 64 rows on a unit of two blocks),
`rays_per_block` rays a block (or unit), the pick folded tile by tile (any n_steps), so a point's
value is the fused callable's bit for bit. Bound on an H100: the products
of (n_steps + n_secant [+ 2]) MLP evals per ray, bf16 ones over the bf16
peak and f32 ones as three tf32 passes over the tf32 peak.

`FusedSampler` is what a fused callable's `.fused_ray_sampler` holds:

    sampler(cam_loc (..., 3), ray_dirs (..., 3), t_lo (...), t_hi (...),
            steps (S,), n_secant=8, margin=0.0, coarse_sweep=False,
            filled=None, swept=None)
      -> (t_pick, f_pick, t_min, z_secant), each shaped like t_lo

`filled` (B,) marks a compacted buffer, t_lo (B, cap) whose first
filled[b] slots of row b hold rays (models/raytracing's sampler buffer,
the presweep's dense buffer): only those are swept, the kernel's persistent
grid walking their tiles (csrc/fused_sampler.cu), and every other slot
reads zeros, in the kernel and in `sweep_plain` alike. `swept`, an int
device tensor, receives the slots the sweep computed (the kernel's tiles;
every slot in the plain version).

With `coarse_sweep` (pallas_sampler.py:97-104) the sweep runs on the bf16
net of the same pack, with the hysteresis `margin`; the bracket ends are
evaluated again at the callable's precision and the secant runs there
too. `packing_stride` carries the capability `models/raytracing` checks
before it asks for a coarse sweep, with the JAX meaning
(raytracing.py:829-836): 3 where the coarse sweep equals a sweep with the
bf16 callable of the same weights (the f32 packs), 2 where the callable is
itself bf16 and coarse equals fine.

A CUDA input launches the kernel or raises; a CPU input runs
`sweep_plain`, the plain branch of `_dense_ray_sampler`
(isopoints_tpu/models/raytracing.py:847-880), which models/raytracing.py
also uses for fields without a fused sampler.
"""

import contextvars
import ctypes
import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from isopoints_torch.ops import _build
from isopoints_torch.utils import eps_denom, fma

KERNEL = _build.LaunchCount("fused_sampler")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib(wide: bool = False) -> ctypes.CDLL:
    """The sampler's library; `wide`: its instances above
    `_build.NARROW_MAX`, csrc/fused_sampler_wide.cu."""
    lib = _build.load("fused_sampler_wide" if wide else "fused_sampler")
    lib.sampler_sweep.argtypes = ([_P] * 5 + [_I, _I, _I, _F, _I, _P, _P]
                                  + [_I, _I, _U, _I, _F, _F, _I, _I, _I, _I]
                                  + [_P, _I, _P] + [_P] * 5)
    lib.sampler_sweep.restype = _I
    return lib


RAYS = (64, 32, 16, 8)   # rays a block the kernel takes


def tile_shape(kernel_hidden: int) -> Tuple[int, int]:
    """(rows of the sampler kernel's tiles, SMs a block of rays takes) at
    an instance's width: (128, 1) up to 256; above, (64, 2), a unit of two
    blocks on csrc/mlp_wide.cuh's tile. A block takes at most rows / 2
    rays."""
    return (128, 1) if kernel_hidden <= _build.NARROW_MAX else (64, 2)


def rays_per_block(n_rays: Union[int, Sequence[int]], n_steps: int,
                   n_secant: int, revalidate: bool, n_sms: int,
                   rows: int = 128, sms: int = 1) -> int:
    """The kernel's rays a block, from the launch's shape: the one of
    `RAYS` up to rows / 2 (`tile_shape`) with the fewest tile rounds on the
    busiest SM, the larger on a tie. A block (one to an SM: the f32 tile's
    shared memory; `sms` SMs for a wide unit) runs ceil(n_steps·rays /
    rows) sweep tiles, then one re-validation tile and one tile a secant
    step whatever its rays, and every tile streams the whole weight stack,
    so the rounds are ceil(tiles / (n_sms / sms)) waves times the tiles a
    block. At the bench trace's 24,576 rays that keeps 64 (384 blocks;
    measured 18.4 ms on an H100 against 23.6 at 32); at a training step's
    1-2k sampler rays it takes 8-16, where 64 would fill 16-32 of the 132
    SMs. Above width 256 (64 rows, two SMs a unit) it takes 32 at both.
    `n_rays` is a launch's ray count, or the filled counts of a compacted
    buffer's rows, whose tiles hold one row's rays each: the rule the
    kernel applies on the device to the counts it is given (`rays_for` in
    csrc/fused_sampler.cu)."""
    tail = int(bool(revalidate)) + n_secant
    slots = max(n_sms // sms, 1)
    counts = [n_rays] if isinstance(n_rays, int) else list(n_rays)

    def rounds(rays):
        tiles = sum(-(-c // rays) for c in counts)
        waves = -(-max(tiles, 1) // slots)
        return waves * (-(-n_steps * rays // rows) + tail)

    return min((r for r in RAYS if 2 * r <= rows), key=lambda r: (rounds(r), -r))


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def secant_scan(sdf_fn: Callable, f_low, f_high, z_low, z_high, origins,
                dirs, n_steps: int) -> torch.Tensor:
    """Fixed-step secant for f(o + z·d) = 0 on [z_low, z_high]
    (parity: raytracing._secant_scan, :442-466)."""
    def z_pred(fl, fh, zl, zh):
        return -fl * (zh - zl) / eps_denom(fh - fl, 1e-12) + zl

    for _ in range(n_steps):
        z = z_pred(f_low, f_high, z_low, z_high)
        f_mid = sdf_fn(fma(z[..., None], dirs, origins))
        low, high = f_mid > 0, f_mid < 0
        z_low = torch.where(low, z, z_low)
        f_low = torch.where(low, f_mid, f_low)
        z_high = torch.where(high, z, z_high)
        f_high = torch.where(high, f_mid, f_high)
    return z_pred(f_low, f_high, z_low, z_high)


def eval_chunked(fn: Callable, pts: torch.Tensor, chunk_rays: int = 0
                 ) -> torch.Tensor:
    """fn over (..., S, 3) proposals, `chunk_rays` rays at a time when > 0
    (the same values, bounded memory; raytracing.py:409-423)."""
    if chunk_rays <= 0:
        return fn(pts)
    flat = pts.reshape(-1, pts.shape[-2], 3)
    return torch.cat([fn(c) for c in flat.split(chunk_rays)]).reshape(pts.shape[:-1])


def sweep_plain(sdf_fn: Callable, cam: torch.Tensor, dirs: torch.Tensor,
                t_lo: torch.Tensor, t_hi: torch.Tensor, steps: torch.Tensor,
                n_secant: int = 8, margin: float = 0.0, chunk_rays: int = 0,
                sdf_fn_coarse: Optional[Callable] = None,
                filled: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
    """Plain dense sampler: (t_pick, f_pick, t_min, z_secant).

    cam, dirs (..., 3); t_lo, t_hi (...); steps (S,). `chunk_rays` > 0
    evaluates the proposals that many rays at a time (same values, bounded
    memory; RayTracingConfig.sampler_chunk_rays). With `sdf_fn_coarse` the
    sweep runs on it and the bracket ends [z_low, t_pick] are evaluated
    again with `sdf_fn` (raytracing.py:872-878); f_pick is then fine. A
    NaN value is skipped by both argmins, as the Pallas kernel skips it
    (the XLA branch's argmin would stop at it). With `filled` (B,), t_lo
    (B, cap): the slots of row b from filled[b] on read zeros, as the
    kernel leaves them; the others are what the call without it gives."""
    if filled is not None:
        outs = sweep_plain(sdf_fn, cam, dirs, t_lo, t_hi, steps, n_secant,
                           margin, chunk_rays, sdf_fn_coarse)
        keep = (torch.arange(t_lo.shape[-1], device=t_lo.device)
                < filled.to(t_lo.device)[:, None])
        return tuple(torch.where(keep, o, 0.0) for o in outs)
    fn_dense = sdf_fn if sdf_fn_coarse is None else sdf_fn_coarse
    ts = fma(steps, (t_hi - t_lo)[..., None], t_lo[..., None])    # (..., S)
    pts = fma(ts[..., None], dirs[..., None, :], cam[..., None, :])
    sdf_val = eval_chunked(fn_dense, pts, chunk_rays)
    n = steps.shape[0]
    countdown = torch.arange(n, 0, -1, dtype=sdf_val.dtype, device=sdf_val.device)
    v = sdf_val + margin
    # The Pallas kernel's carry (pallas_sampler.py:76-92): a step replaces
    # the pick where its cost is strictly below the best so far (from +inf)
    # and the f-argmin where f is strictly below the least so far, so a NaN
    # step never wins either, and a ray with no such step keeps the zeros
    # the carry starts from.
    cost = torch.where(torch.isnan(v), math.inf, torch.sign(v) * countdown)
    f_key = torch.where(torch.isnan(sdf_val), math.inf, sdf_val)
    idx, i_min = torch.argmin(cost, dim=-1), torch.argmin(f_key, dim=-1)

    def pick(a, i, valid):
        return torch.where(valid, torch.gather(a, -1, i[..., None])[..., 0], 0.0)

    picked = (cost < math.inf).any(-1)
    t_pick, f_pick = pick(ts, idx, picked), pick(sdf_val, idx, picked)
    t_min = pick(ts, i_min, (f_key < math.inf).any(-1))
    idx_lo = torch.clamp(idx - 1, min=0)
    z_low, f_low = pick(ts, idx_lo, picked), pick(sdf_val, idx_lo, picked)
    if sdf_fn_coarse is not None:
        t2 = torch.stack([z_low, t_pick], dim=-1)
        f2 = sdf_fn(fma(t2[..., None], dirs[..., None, :], cam[..., None, :]))
        f_low, f_pick = f2[..., 0], f2[..., 1]
    z_secant = secant_scan(sdf_fn, f_low, f_pick, z_low, t_pick, cam, dirs,
                           n_secant)
    return t_pick, f_pick, t_min, z_secant


# The rows of the compacted buffer that `sweep_cuda` sweeps, (filled (B,)
# int32, swept or None), set by `FusedSampler.__call__` around the call:
# `sweep_cuda` keeps the arguments by which the benchmark's launch hook
# (benchmark/trace.launch_hook) wraps and records it.
_ROWS = contextvars.ContextVar("fused_sampler_rows", default=(None, None))


def sweep_cuda(pack, cam: torch.Tensor, dirs: torch.Tensor, t_lo: torch.Tensor,
               t_hi: torch.Tensor, steps: torch.Tensor, n_secant: int,
               margin: float, coarse_sweep: bool = False,
               fine_bf16: bool = False) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel: cam, dirs (R, 3), t_lo, t_hi (R,), steps
    (S,), all contiguous float32 on the weights' CUDA device. The sweep
    runs at bf16 with `coarse_sweep` (then the bracket is re-validated) and
    else at the fine precision (`fine_bf16`). Under `FusedSampler`'s
    `filled` the R slots are its B rows and only their filled slots are
    swept; the outputs of the others are zeros."""
    r = dirs.shape[0]
    for name, t, shape in (("cam", cam, (r, 3)), ("dirs", dirs, (r, 3)),
                           ("t_lo", t_lo, (r,)), ("t_hi", t_hi, (r,)),
                           ("steps", steps, (steps.shape[0],))):
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: the sampler kernel takes contiguous "
                             f"float32 CUDA tensors")
        if tuple(t.shape) != shape or t.device != pack.device:
            raise ValueError(f"{name}: expected {shape} on {pack.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if n_secant < 0:
        raise ValueError("n_secant must be >= 0")
    n_steps = steps.shape[0]
    if n_steps < 1:
        raise ValueError("the sampler kernel takes at least one step")
    filled, swept = _ROWS.get()
    n_rows = 0
    if filled is not None:
        n_rows = filled.shape[0]
        if (filled.dtype != torch.int32 or not filled.is_contiguous()
                or filled.device != pack.device or filled.dim() != 1
                or n_rows < 1 or r % n_rows):
            raise ValueError(f"filled: expected a contiguous int32 (B,) tensor "
                             f"on {pack.device} with B dividing {r}")
    if swept is not None and (swept.dtype != torch.int32 or swept.numel() != 1
                              or swept.device != pack.device):
        raise ValueError(f"swept: expected one int32 on {pack.device}")
    arch = pack.arch_args()
    lib = _lib(arch[0] > _build.NARROW_MAX)
    outs = torch.zeros((4, r), dtype=torch.float32, device=dirs.device).unbind(0)
    stream = torch.cuda.current_stream(dirs.device).cuda_stream
    sweep_bf16 = bool(coarse_sweep or fine_bf16)
    sw = (_P * 7)(*pack.mma_net(sweep_bf16)[1][:7])
    fw = (_P * 7)(*pack.mma_net(bool(fine_bf16))[1][:7])
    rays = rays_per_block(r, n_steps, int(n_secant), coarse_sweep,
                          _n_sms(dirs.device.index or 0), *tile_shape(arch[0]))
    KERNEL.launch(r, n_steps=n_steps, n_secant=int(n_secant),
                  coarse_sweep=bool(coarse_sweep), fine_bf16=bool(fine_bf16))
    err = lib.sampler_sweep(
        cam.data_ptr(), dirs.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(),
        steps.data_ptr(), r, n_steps, int(n_secant), float(margin),
        int(bool(coarse_sweep)), sw, fw, *arch, *pack.omegas(),
        int(pack.kind == "siren"), int(sweep_bf16), int(bool(fine_bf16)), rays,
        None if filled is None else filled.data_ptr(), n_rows,
        None if swept is None else swept.data_ptr(),
        *(o.data_ptr() for o in outs), stream)
    _build.check_launch(lib, err, "fused_sampler")
    return outs


class FusedSampler:
    """In-kernel dense sampler over a SirenPack or an IgrPack (see the
    module docstring). `sdf_plain` is the callable's plain value function,
    `sdf_plain_coarse` the plain bf16 one, used on CPU."""

    def __init__(self, pack, sdf_plain: Callable, sdf_plain_coarse: Callable,
                 fine_bf16: bool):
        self.pack = pack
        self.sdf_plain = sdf_plain
        self.sdf_plain_coarse = sdf_plain_coarse
        self.fine_bf16 = fine_bf16
        self.packing_stride = 2 if fine_bf16 else 3

    @torch.no_grad()
    def __call__(self, cam_loc, ray_dirs, t_lo, t_hi, steps,
                 n_secant: int = 8, margin: float = 0.0,
                 coarse_sweep: bool = False,
                 filled: Optional[torch.Tensor] = None,
                 swept: Optional[torch.Tensor] = None):
        shp = t_lo.shape
        if filled is not None and (t_lo.dim() != 2 or filled.shape != shp[:1]):
            raise ValueError(f"filled: expected ({shp[0]},) for a (B, cap) "
                             f"buffer, got {tuple(filled.shape)} for {tuple(shp)}")
        cam = torch.broadcast_to(cam_loc, ray_dirs.shape).reshape(-1, 3)
        drs = ray_dirs.reshape(-1, 3)
        tlo, thi = t_lo.reshape(-1), t_hi.reshape(-1)
        if drs.is_cuda:
            rows = None if filled is None else filled.to(torch.int32).contiguous()
            token = _ROWS.set((rows, swept))
            try:
                outs = sweep_cuda(self.pack, cam.contiguous(), drs.contiguous(),
                                  tlo.contiguous(), thi.contiguous(),
                                  steps.contiguous(), n_secant, margin,
                                  coarse_sweep, self.fine_bf16)
            finally:
                _ROWS.reset(token)
        elif drs.device.type == "cpu":
            if filled is not None:  # the rows, for the zeros past their counts
                cam, drs = cam.reshape(shp + (3,)), drs.reshape(shp + (3,))
                tlo, thi = t_lo, t_hi
            outs = sweep_plain(self.sdf_plain, cam, drs, tlo, thi, steps,
                               n_secant, margin,
                               sdf_fn_coarse=(self.sdf_plain_coarse
                                              if coarse_sweep else None),
                               filled=filled)
            if swept is not None:
                swept += t_lo.numel()
        else:
            raise ValueError(f"the sampler runs on CUDA or CPU, not {drs.device}")
        return tuple(o.reshape(shp) for o in outs)
