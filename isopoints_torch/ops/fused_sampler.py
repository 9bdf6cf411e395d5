"""Fused dense ray sampler: a hand-written CUDA kernel and its plain twin.

Replaces `make_sampler` / `_sweep_kernel` of
isopoints_tpu/ops/pallas_sampler.py (:52, :129) on its fine-sweep path.
The kernel (csrc/fused_sampler.cu) evaluates the n_steps proposals of 16
rays per block as MLP tiles, picks the first sign change (strict first
minimum of sign(f + margin)·countdown), the bracket and the f-argmin, and
runs the fixed secant, all without writing a (rays × n_steps) array to
device memory. Bound on an H100: the f32 CUDA-core rate over
(n_steps + n_secant) SIREN evals per ray.

`FusedSampler` is what `FusedSirenSDF.fused_ray_sampler` holds:

    sampler(cam_loc (..., 3), ray_dirs (..., 3), t_lo (...), t_hi (...),
            steps (S,), n_secant=8, margin=0.0, coarse_sweep=False)
      -> (t_pick, f_pick, t_min, z_secant), each shaped like t_lo

A CUDA input launches the kernel or raises; a CPU input runs
`sweep_plain`, the plain branch of `_dense_ray_sampler`
(isopoints_tpu/models/raytracing.py:847-880), which models/raytracing.py
also uses for fields without a fused sampler.
"""

import ctypes
import functools
from typing import Callable, Tuple

import torch

from isopoints_torch.ops import _build
from isopoints_torch.utils import eps_denom, fma


KERNEL = _build.LaunchCount("fused_sampler")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_sampler")
    lib.sampler_sweep.argtypes = ([_P] * 5 + [_I, _I, _I, _F] + [_P] * 6
                                  + [_I, _I, _F, _F] + [_P] * 5)
    lib.sampler_sweep.restype = _I
    lib.sampler_max_steps.argtypes = [_I]
    lib.sampler_max_steps.restype = _I
    return lib


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


def sweep_plain(sdf_fn: Callable, cam: torch.Tensor, dirs: torch.Tensor,
                t_lo: torch.Tensor, t_hi: torch.Tensor, steps: torch.Tensor,
                n_secant: int = 8, margin: float = 0.0, chunk_rays: int = 0
                ) -> Tuple[torch.Tensor, ...]:
    """Plain dense sampler: (t_pick, f_pick, t_min, z_secant).

    cam, dirs (..., 3); t_lo, t_hi (...); steps (S,). `chunk_rays` > 0
    evaluates the proposals that many rays at a time (same values, bounded
    memory; RayTracingConfig.sampler_chunk_rays)."""
    ts = fma(steps, (t_hi - t_lo)[..., None], t_lo[..., None])    # (..., S)
    pts = fma(ts[..., None], dirs[..., None, :], cam[..., None, :])
    if chunk_rays > 0:
        flat = pts.reshape(-1, steps.shape[0], 3)
        sdf_val = torch.cat([sdf_fn(c) for c in flat.split(chunk_rays)]
                            ).reshape(ts.shape)
    else:
        sdf_val = sdf_fn(pts)
    n = steps.shape[0]
    countdown = torch.arange(n, 0, -1, dtype=sdf_val.dtype, device=sdf_val.device)
    idx = torch.argmin(torch.sign(sdf_val + margin) * countdown, dim=-1)

    def pick(a, i):
        return torch.gather(a, -1, i[..., None])[..., 0]

    t_pick, f_pick = pick(ts, idx), pick(sdf_val, idx)
    t_min = pick(ts, torch.argmin(sdf_val, dim=-1))
    idx_lo = torch.clamp(idx - 1, min=0)
    z_low, f_low = pick(ts, idx_lo), pick(sdf_val, idx_lo)
    z_secant = secant_scan(sdf_fn, f_low, f_pick, z_low, t_pick, cam, dirs,
                           n_secant)
    return t_pick, f_pick, t_min, z_secant


def sweep_cuda(pack, cam: torch.Tensor, dirs: torch.Tensor, t_lo: torch.Tensor,
               t_hi: torch.Tensor, steps: torch.Tensor, n_secant: int,
               margin: float) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel: cam, dirs (R, 3), t_lo, t_hi (R,), steps
    (S,), all contiguous float32 on the weights' CUDA device."""
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
    lib = _lib()
    _, wargs = pack.kernel_args()
    n_steps = steps.shape[0]
    max_steps = lib.sampler_max_steps(pack.hidden)
    if not 1 <= n_steps <= max_steps:
        raise ValueError(f"the sampler kernel takes 1..{max_steps} steps at "
                         f"hidden {pack.hidden}, got {n_steps}")
    outs = [torch.empty(r, dtype=torch.float32, device=dirs.device)
            for _ in range(4)]
    stream = torch.cuda.current_stream(dirs.device).cuda_stream
    KERNEL.launches += 1
    err = lib.sampler_sweep(cam.data_ptr(), dirs.data_ptr(), t_lo.data_ptr(),
                            t_hi.data_ptr(), steps.data_ptr(), r, n_steps,
                            int(n_secant), float(margin), *wargs,
                            *(o.data_ptr() for o in outs), stream)
    _build.check_launch(lib, err, "fused_sampler")
    return tuple(outs)


class FusedSampler:
    """In-kernel dense sampler over a SirenPack (see module docstring).
    `sdf_plain` is the pack's plain value function, used on CPU."""

    def __init__(self, pack, sdf_plain: Callable):
        self.pack = pack
        self.sdf_plain = sdf_plain

    @torch.no_grad()
    def __call__(self, cam_loc, ray_dirs, t_lo, t_hi, steps,
                 n_secant: int = 8, margin: float = 0.0,
                 coarse_sweep: bool = False):
        if coarse_sweep:
            raise NotImplementedError(
                "coarse_sweep (bf16 sweep + bracket re-validation) is not "
                "ported yet: ROADMAP slice 2, the production trace schedule")
        shp = t_lo.shape
        cam = torch.broadcast_to(cam_loc, ray_dirs.shape).reshape(-1, 3)
        drs = ray_dirs.reshape(-1, 3)
        tlo, thi = t_lo.reshape(-1), t_hi.reshape(-1)
        if drs.is_cuda:
            outs = sweep_cuda(self.pack, cam.contiguous(), drs.contiguous(),
                              tlo.contiguous(), thi.contiguous(),
                              steps.contiguous(), n_secant, margin)
        elif drs.device.type == "cpu":
            outs = sweep_plain(self.sdf_plain, cam, drs, tlo, thi, steps,
                               n_secant, margin)
        else:
            raise ValueError(f"the sampler runs on CUDA or CPU, not {drs.device}")
        return tuple(o.reshape(shp) for o in outs)
