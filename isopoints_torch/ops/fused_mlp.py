"""Fused SIREN SDF-MLP: a hand-written CUDA kernel and its plain twin.

Replaces `make_fused_siren_sdf` / `_siren_kernel` of
isopoints_tpu/ops/pallas_mlp.py (:250, :309). The kernel
(csrc/fused_mlp.cu + csrc/siren.cuh) evaluates the whole SIREN stack per
64-row tile with the activations in shared memory, in plain f32 FMA, and
with `with_grad` also the input gradient as three forward-mode tangent
rows per point. Its bound on an H100 is the f32 CUDA-core rate:
2(3H + L·H² + H) FLOP per value eval (~0.40 MFLOP at 3×256), about 4x
that with the gradient.

`make_fused_siren_sdf(field)` returns the callable `sdf(x)`, which
carries `.sdf_and_grad` and `.fused_ray_sampler` (ops/fused_sampler.py)
as the JAX version does, so `models/fields.sdf_and_grad` and
`models/raytracing` dispatch the same way. The weights are detached when
the callable is made and every call runs under `torch.no_grad()`: it
serves the no-grad tracing paths only (the `stop_gradient` contract of
isopoints_tpu/models/implicit.py:147-151).

A CUDA input launches the kernel or raises; a CPU input runs the plain
twin (`siren_sdf_plain`, `siren_sdf_and_grad_plain`) — the same function
in PyTorch ops, which is what the CPU tests compare with JAX.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from isopoints_torch.models.fields import SirenField
from isopoints_torch.ops import _build
from isopoints_torch.ops.fused_sampler import FusedSampler


KERNEL = _build.LaunchCount("fused_mlp")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    lib.siren_forward.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _F, _F, _P, _P, _P]
    lib.siren_forward.restype = _I
    return lib


class SirenPack:
    """Detached SIREN weights: the (out, in) layers for the twin, and on
    first CUDA use the kernel's layout (hidden layers stacked as W^T)."""

    def __init__(self, field: SirenField):
        self.ws = tuple(l.weight.detach() for l in field.layers)
        self.bs = tuple(l.bias.detach() for l in field.layers)
        self.hidden = field.hidden_size
        self.n_hidden = field.n_layers
        self.omega_first = float(field.first_omega_0)
        self.omega_hidden = float(field.hidden_omega_0)
        self.device = self.ws[0].device
        self._kernel_args = None

    def kernel_args(self) -> Tuple:
        """(tensors kept alive, pointer/int/float args) for the launchers:
        w0, b0, wh_t, bh, wout, bout, hidden, n_hidden, ω₀, ω."""
        if self._kernel_args is None:
            h = self.hidden
            if h % 32 != 0 or not 32 <= h <= 256:
                raise ValueError(f"the CUDA SIREN kernel needs a hidden width "
                                 f"that is a multiple of 32 in [32, 256], got {h}")
            ws, bs = self.ws, self.bs
            f32 = dict(dtype=torch.float32, device=self.device)
            mid = ws[1:-1]
            wh_t = (torch.stack([w.t() for w in mid]) if mid
                    else torch.zeros((0, h, h), **f32)).contiguous()
            bh = (torch.stack(bs[1:-1]) if mid
                  else torch.zeros((0, h), **f32)).contiguous()
            tensors = (ws[0].contiguous(), bs[0].contiguous(), wh_t, bh,
                       ws[-1].reshape(-1).contiguous(), bs[-1].contiguous())
            for t in tensors:
                if t.dtype != torch.float32:
                    raise TypeError("the CUDA SIREN kernel takes float32 weights")
            ptrs = tuple(t.data_ptr() for t in tensors)
            self._kernel_args = (tensors, ptrs + (h, self.n_hidden,
                                                  self.omega_first,
                                                  self.omega_hidden))
        return self._kernel_args


def siren_sdf_plain(pack: SirenPack, x: torch.Tensor) -> torch.Tensor:
    """Plain twin of the value kernel: x (N, 3) -> (N,)."""
    ws, bs = pack.ws, pack.bs
    h = torch.sin(pack.omega_first * F.linear(x, ws[0], bs[0]))
    for w, b in zip(ws[1:-1], bs[1:-1]):
        h = torch.sin(pack.omega_hidden * F.linear(h, w, b))
    return F.linear(h, ws[-1], bs[-1])[..., 0]


def siren_sdf_and_grad_plain(pack: SirenPack, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the value+grad kernel: forward-mode tangents
    J ← (J Wᵀ)·ω cos(ω z), as the kernel carries them. x (N, 3) ->
    ((N,), (N, 3))."""
    ws, bs = pack.ws, pack.bs
    a = pack.omega_first * F.linear(x, ws[0], bs[0])
    h = torch.sin(a)
    jac = (pack.omega_first * torch.cos(a))[:, None, :] * ws[0].t()[None]
    for w, b in zip(ws[1:-1], bs[1:-1]):
        a = pack.omega_hidden * F.linear(h, w, b)
        h = torch.sin(a)
        jac = (pack.omega_hidden * torch.cos(a))[:, None, :] * (jac @ w.t())
    out = F.linear(h, ws[-1], bs[-1])[..., 0]
    grad = (jac @ ws[-1].t())[..., 0]
    return out, grad


def _check_points(x: torch.Tensor, pack: SirenPack) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"fused SIREN takes float32 points, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"fused SIREN takes (N, 3) points, got {tuple(x.shape)}")
    if x.device != pack.device:
        raise ValueError(f"points on {x.device}, weights on {pack.device}")


def siren_forward_cuda(pack: SirenPack, x: torch.Tensor, with_grad: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel on (N, 3) contiguous float32 CUDA points."""
    _check_points(x, pack)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("siren_forward_cuda takes a contiguous CUDA tensor")
    lib = _lib()
    _, wargs = pack.kernel_args()
    n = x.shape[0]
    val = torch.empty(n, dtype=torch.float32, device=x.device)
    grad = (torch.empty((n, 3), dtype=torch.float32, device=x.device)
            if with_grad else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launches += 1
    err = lib.siren_forward(x.data_ptr(), n, *wargs, val.data_ptr(),
                            grad.data_ptr() if with_grad else None, stream)
    _build.check_launch(lib, err, "fused_mlp")
    return val, grad


def _run(pack: SirenPack, x: torch.Tensor, with_grad: bool):
    flat = x.reshape(-1, 3)
    if flat.is_cuda:
        val, grad = siren_forward_cuda(pack, flat.contiguous(), with_grad)
        return (val, grad) if with_grad else val
    if flat.device.type != "cpu":
        raise ValueError(f"fused SIREN runs on CUDA or CPU, not {flat.device}")
    _check_points(flat, pack)
    if with_grad:
        return siren_sdf_and_grad_plain(pack, flat)
    return siren_sdf_plain(pack, flat)


class FusedSirenSDF:
    """`sdf(x)`: (..., 3) -> (...), on frozen weights, no autograd.

    Attributes:
      sdf_and_grad(x): (..., 3) -> ((...), (..., 3)).
      fused_ray_sampler: the in-kernel dense sampler on the same weights.
    """

    def __init__(self, field: SirenField):
        self.pack = SirenPack(field)
        self.fused_ray_sampler = FusedSampler(
            self.pack, lambda p: siren_sdf_plain(self.pack, p))

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self.pack, x, False).reshape(x.shape[:-1])

    @torch.no_grad()
    def sdf_and_grad(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        v, g = _run(self.pack, x, True)
        return v.reshape(x.shape[:-1]), g.reshape(x.shape)


def make_fused_siren_sdf(field: SirenField) -> FusedSirenSDF:
    return FusedSirenSDF(field)

