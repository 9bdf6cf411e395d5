"""Fused SDF-MLPs: hand-written CUDA kernels and their plain versions.

SIREN. Replaces `make_fused_siren_sdf` / `_siren_kernel` of
isopoints_tpu/ops/pallas_mlp.py (:250, :309). The kernel
(csrc/fused_mlp.cu on csrc/mlp_mma.cuh, the tensor-core tile the IGR
kernels use, with the sine as its activation) evaluates the whole SIREN
stack per tile with the activations in shared memory, the hidden products
as 3xTF32 on the tensor cores (the weights split once on the host,
`SirenPack.mma_net`), the first layer, head and sine epilogue in f32 on
the CUDA cores, and with `with_grad` also the input gradient as three
forward-mode tangent rows per point. A launch takes tiles of 128 rows, or
of 32 where 128-row tiles would leave half the SMs idle. Its bound on an H100:
2(3H + L·H² + H) FLOP per value eval (~0.40 MFLOP at 3×256), about 4x
that with the gradient, as three tf32 passes over the tf32 tensor-core
peak. Only the f32 mode is ported; the bf16 mode comes with the next
slice (ROADMAP "Slices of the port"). The SIREN sampler
(ops/fused_sampler.py) still evaluates on csrc/siren.cuh's f32 FMA tile,
from `SirenPack.kernel_args`.

IGR. Replaces `make_fused_igr_sdf` / `_igr_kernel` (pallas_mlp.py:417,
:489) for an `SDFField` without positional encoding: softplus(β=100)
layers, the input concatenated back and scaled by 1/√2 at `skip_in`,
optional final tanh. The kernel (csrc/fused_igr.cu + csrc/mlp_mma.cuh)
runs the hidden products on the tensor cores (`mma.sync`, 128 rows per
block, the tangent rows of `with_grad` as extra rows) and the first
layer, the head and the softplus epilogue on the CUDA cores in f32. Two
precisions: `"f32"`, the fine path (JAX's `f32x3`/`highest`), as 3xTF32:
each operand split into tf32 hi and lo parts, hi·hi + hi·lo + lo·hi
accumulated in f32, the weights split once on the host
(`IgrPack.mma_net`, `tf32_split`); and `"bf16"`, the coarse path: JAX's
`bf16` mode, every matmul operand (value and tangent rows) rounded to
bf16, the products exact in f32 and accumulated in f32, biases f32. The
plain versions compute both in float32 PyTorch ops (bf16 rounding the
operands). The weight-norm fold w = g·v/max(‖v‖, ε) happens once, when
the callable is made (pallas_mlp.py:507-516).

`make_fused_sdf_fn(field, precision)` dispatches as the JAX
`make_fused_sdf_fn` does (pallas_mlp.py:383-410) and returns a callable
`sdf(x)` carrying `.sdf_and_grad`, `.fused_ray_sampler`
(ops/fused_sampler.py) and `.fused_trace_stepper` (ops/fused_trace.py), so
`models/fields.sdf_and_grad` and `models/raytracing` dispatch the same
way. It returns None for an `SDFField` with positional encoding
(`num_frequencies > 0`): neither package has a kernel for that field. The
weights are detached when the callable is made and every call runs under
`torch.no_grad()`: it serves the no-grad tracing paths only (the
`stop_gradient` contract of isopoints_tpu/models/implicit.py:147-151).

A CUDA input launches the kernel or raises; a CPU input runs the plain
version (`siren_sdf_plain`, `siren_sdf_and_grad_plain`, `igr_sdf_plain`,
`igr_sdf_and_grad_plain`): the same function in PyTorch ops, which is what
the CPU tests compare with JAX.
"""

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from isopoints_torch.models.fields import SDFField, SirenField, softplus_beta
from isopoints_torch.ops import _build
from isopoints_torch.ops.fused_sampler import FusedSampler
from isopoints_torch.ops.fused_trace import TraceStepper

KERNEL = _build.LaunchCount("fused_mlp")
IGR_KERNEL = _build.LaunchCount("fused_igr")

PRECISIONS = ("f32", "bf16")
NEXT_SLICE = ("is not ported yet: it comes with the next slice (ROADMAP "
              "'Slices of the port': the SIREN bf16 coarse mode)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    lib.siren_forward.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _F, _F, _P, _P, _P]
    lib.siren_forward.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _igr_lib() -> ctypes.CDLL:
    lib = _build.load("fused_igr")
    lib.igr_forward.argtypes = [_P, _I] + [_P] * 7 + [_I, _I, _U, _I, _I,
                                                      _P, _P, _P]
    lib.igr_forward.restype = _I
    return lib


def _check_hidden(h: int, what: str) -> None:
    if h % 32 != 0 or not 32 <= h <= 256:
        raise ValueError(f"the CUDA {what} kernel needs a hidden width that "
                         f"is a multiple of 32 in [32, 256], got {h}")


def _round_bf16(a: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 (ties to even), kept as float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest tf32 (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32` does: add half an ulp to the magnitude's
    bits and clear the low 13."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(a) and lo = tf32(a − hi): the operand split of
    the kernel's 3xTF32 products."""
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


class SirenPack:
    """Detached SIREN weights: the (out, in) layers for the plain version,
    and on first CUDA use the kernels' layouts: `mma_net` for the fused
    MLP's tensor-core tile, `kernel_args` for the sampler's f32 FMA tile."""
    kind = "siren"

    def __init__(self, field: SirenField):
        self.ws = tuple(l.weight.detach() for l in field.layers)
        self.bs = tuple(l.bias.detach() for l in field.layers)
        self.hidden = field.hidden_size
        self.n_hidden = field.n_layers
        self.omega_first = float(field.first_omega_0)
        self.omega_hidden = float(field.hidden_omega_0)
        self.device = self.ws[0].device
        self._kernel_args = None
        self._mma_net = None

    def mma_net(self) -> Tuple[List[torch.Tensor], Tuple]:
        """(tensors kept alive, pointer/int/float args) of the fused MLP's
        tensor-core tile (mlp_mma.cuh): w0 (H, 3), b0 (H,), wh and wh_lo,
        the hidden layers (L, H, H) as (out, in), the K-major B operand,
        split into tf32 hi and lo (`tf32_split`), bh (L, H), wout (H,),
        bout (1,); then hidden, n_hidden, ω₀, ω."""
        if self._mma_net is None:
            h = self.hidden
            _check_hidden(h, "SIREN")
            ws, bs = self.ws, self.bs
            for t in ws + bs:
                if t.dtype != torch.float32:
                    raise TypeError("the CUDA SIREN kernel takes float32 weights")
            mid = ws[1:-1]
            wh = (torch.stack(mid) if mid else
                  torch.zeros((0, h, h), dtype=torch.float32, device=self.device))
            bh = (torch.stack(bs[1:-1]) if mid else
                  torch.zeros((0, h), dtype=torch.float32, device=self.device))
            tensors = [t.contiguous() for t in
                       (ws[0], bs[0], *tf32_split(wh), bh, ws[-1].reshape(-1),
                        bs[-1])]
            self._mma_net = (tensors, tuple(t.data_ptr() for t in tensors) + (
                h, self.n_hidden, self.omega_first, self.omega_hidden))
        return self._mma_net

    def kernel_args(self) -> Tuple:
        """(tensors kept alive, pointer/int/float args) for the sampler's
        f32 FMA tile (siren.cuh): w0, b0, wh_t, bh, wout, bout, hidden,
        n_hidden, ω₀, ω."""
        if self._kernel_args is None:
            h = self.hidden
            _check_hidden(h, "SIREN")
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
    """Plain version of the value kernel: x (N, 3) -> (N,)."""
    ws, bs = pack.ws, pack.bs
    h = torch.sin(pack.omega_first * F.linear(x, ws[0], bs[0]))
    for w, b in zip(ws[1:-1], bs[1:-1]):
        h = torch.sin(pack.omega_hidden * F.linear(h, w, b))
    return F.linear(h, ws[-1], bs[-1])[..., 0]


def siren_sdf_and_grad_plain(pack: SirenPack, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the value+grad kernel: forward-mode tangents
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


def _check_points(x: torch.Tensor, pack) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the fused MLP takes float32 points, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"the fused MLP takes (N, 3) points, got {tuple(x.shape)}")
    if x.device != pack.device:
        raise ValueError(f"points on {x.device}, weights on {pack.device}")


def _outputs(x: torch.Tensor, with_grad: bool):
    n = x.shape[0]
    val = torch.empty(n, dtype=torch.float32, device=x.device)
    grad = (torch.empty((n, 3), dtype=torch.float32, device=x.device)
            if with_grad else None)
    return val, grad


def siren_forward_cuda(pack: SirenPack, x: torch.Tensor, with_grad: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel on (N, 3) contiguous float32 CUDA points."""
    _check_points(x, pack)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("siren_forward_cuda takes a contiguous CUDA tensor")
    lib = _lib()
    _, wargs = pack.mma_net()
    val, grad = _outputs(x, with_grad)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launches += 1
    err = lib.siren_forward(x.data_ptr(), x.shape[0], *wargs, val.data_ptr(),
                            grad.data_ptr() if with_grad else None, stream)
    _build.check_launch(lib, err, "fused_mlp")
    return val, grad


# ---------------------------------------------------------------------------
# IGR
# ---------------------------------------------------------------------------

class IgrPack:
    """Detached IGR weights of an `SDFField` without positional encoding,
    weight norm folded: the (out, in) layers for the plain versions (f32
    and bf16-rounded), and on first CUDA use the kernels' padded layout
    `mma_net`, the tensor-core tile's, which every IGR kernel reads."""
    kind = "igr"

    def __init__(self, field: SDFField):
        if field.num_frequencies > 0:
            raise ValueError("the fused IGR path needs num_frequencies <= 0 "
                             "(raw xyz input), as pallas_mlp.py:502 asserts")
        with torch.no_grad():
            self.ws = tuple(l.weight.detach().clone() for l in field.layers)
            self.bs = tuple(l.bias.detach().clone() for l in field.layers)
        self.ws_bf16 = tuple(_round_bf16(w) for w in self.ws)
        self.hidden = field.hidden_size
        self.n_layers = len(self.ws)
        self.skip_in = tuple(field.skip_in)
        self.final_tanh = bool(field.final_tanh)
        self.device = self.ws[0].device
        self._mma_nets = {}

    def weights(self, bf16: bool) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        return (self.ws_bf16 if bf16 else self.ws), self.bs

    def skip_mask(self) -> int:
        return sum(1 << l for l in self.skip_in if 0 <= l < self.n_layers)

    def arch_args(self) -> Tuple[int, int, int, int]:
        """hidden, n_hidden, skip mask, final_tanh for the launchers."""
        return (self.hidden, self.n_layers - 2, self.skip_mask(),
                int(self.final_tanh))

    def mma_net(self, bf16: bool
                ) -> Tuple[List[torch.Tensor], List[Optional[int]]]:
        """(tensors kept alive, pointers) of the tensor-core tile's layout
        (mlp_mma.cuh), which the fused IGR kernel, the IGR sampler and the
        march read: w0 (H, 3), b0 (H,), wh, wh_lo, bh (L, H), wout (H,),
        bout (1,), each layer zero-padded to H outputs. The hidden layers
        stay (L, H, H) as (out, in), the K-major B operand: in bf16 as
        `torch.bfloat16` (the values are bf16 already), in f32 as the tf32
        split `tf32_split`, hi in wh and lo in wh_lo (None in bf16)."""
        if bf16 not in self._mma_nets:
            h, nl = self.hidden, self.n_layers
            _check_hidden(h, "IGR")
            if nl < 2 or 0 in self.skip_in or self.ws[0].shape[1] != 3:
                raise ValueError("the CUDA IGR kernel needs >= 2 layers on raw "
                                 "xyz and no skip at the first layer")
            ws, bs = self.weights(bf16)
            for w, b in zip(ws, bs):
                if w.dtype != torch.float32 or b.dtype != torch.float32:
                    raise TypeError("the CUDA IGR kernel takes float32 weights")
            for l in range(1, nl):
                if ws[l].shape[1] != h:
                    raise ValueError(f"layer {l} takes {ws[l].shape[1]} inputs, "
                                     f"the kernel needs {h}")

            def pad(w, b):
                out = w.shape[0]
                return F.pad(w, (0, 0, 0, h - out)), F.pad(b, (0, h - out))

            w0, b0 = pad(ws[0], bs[0])
            mid = [pad(w, b) for w, b in zip(ws[1:-1], bs[1:-1])]
            f32 = dict(dtype=torch.float32, device=self.device)
            wh = (torch.stack([w for w, _ in mid]) if mid
                  else torch.zeros((0, h, h), **f32))
            bh = (torch.stack([b for _, b in mid]) if mid
                  else torch.zeros((0, h), **f32))
            his = (wh.to(torch.bfloat16), None) if bf16 else tf32_split(wh)
            tensors = [None if t is None else t.contiguous() for t in
                       (w0, b0, *his, bh, ws[-1].reshape(-1), bs[-1])]
            self._mma_nets[bf16] = (tensors, [None if t is None else t.data_ptr()
                                              for t in tensors])
        return self._mma_nets[bf16]


def _linear_exact(a: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.linear with each sum formed in float64 and rounded once to
    float32."""
    return F.linear(a.double(), w.double(),
                    None if b is None else b.double()).float()


def _igr_layers(pack: IgrPack, bf16: bool, exact_sums: bool):
    ws, bs = pack.weights(bf16)
    rnd = _round_bf16 if bf16 else (lambda a: a)
    lin = _linear_exact if exact_sums else F.linear
    return ws, bs, rnd, lin, 1.0 / math.sqrt(2.0)


def igr_sdf_plain(pack: IgrPack, x: torch.Tensor, bf16: bool = False,
                  exact_sums: bool = False) -> torch.Tensor:
    """Plain version of the value kernel, x (N, 3) -> (N,): the JAX
    `_igr_kernel` value path, with every matmul operand rounded to bf16
    when `bf16`. `exact_sums` forms each product's sum in float64 and
    rounds it once (the float32 epilogue unchanged): the reference the
    tensor-core kernel's bf16 mode is held to, since its sums are neither
    exact nor float32 sums in this version's order."""
    ws, bs, rnd, lin, inv_sqrt2 = _igr_layers(pack, bf16, exact_sums)
    h = x
    nl = len(ws)
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in pack.skip_in:
            h = torch.cat([h, x], dim=-1) * inv_sqrt2
        z = lin(rnd(h), w, b)
        h = softplus_beta(z) if l < nl - 1 else z
    if pack.final_tanh:
        h = torch.tanh(h)
    return h[..., 0]


def igr_sdf_and_grad_plain(pack: IgrPack, x: torch.Tensor, bf16: bool = False,
                           exact_sums: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the value+grad kernel: forward-mode tangents
    J ← (J Wᵀ)·σ(βz), the skip appending e_k and scaling by 1/√2, the tanh
    head scaling by 1 − tanh², tangent operands rounded like the values
    (`exact_sums` as in `igr_sdf_plain`). x (N, 3) -> ((N,), (N, 3))."""
    ws, bs, rnd, lin, inv_sqrt2 = _igr_layers(pack, bf16, exact_sums)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], 3, 3)
    h, jac = x, eye                                   # jac (N, 3 tangents, width)
    nl = len(ws)
    for l, (w, b) in enumerate(zip(ws, bs)):
        if l in pack.skip_in:
            h = torch.cat([h, x], dim=-1) * inv_sqrt2
            jac = torch.cat([jac, eye], dim=-1) * inv_sqrt2
        z = lin(rnd(h), w, b)
        jz = lin(rnd(jac), w)
        if l < nl - 1:
            h = softplus_beta(z)
            jac = torch.sigmoid(100.0 * z)[:, None, :] * jz
        else:
            h, jac = z, jz
    if pack.final_tanh:
        t = torch.tanh(h)
        jac = (1.0 - t * t)[:, None, :] * jac
        h = t
    return h[..., 0], jac[..., 0]


def igr_forward_cuda(pack: IgrPack, x: torch.Tensor, with_grad: bool,
                     bf16: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel on (N, 3) contiguous float32 CUDA points."""
    _check_points(x, pack)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("igr_forward_cuda takes a contiguous CUDA tensor")
    lib = _igr_lib()
    _, ptrs = pack.mma_net(bf16)
    val, grad = _outputs(x, with_grad)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    IGR_KERNEL.launches += 1
    err = lib.igr_forward(x.data_ptr(), x.shape[0], *ptrs, *pack.arch_args(),
                          int(bf16), val.data_ptr(),
                          grad.data_ptr() if with_grad else None, stream)
    _build.check_launch(lib, err, "fused_igr")
    return val, grad


# ---------------------------------------------------------------------------
# The fused callables
# ---------------------------------------------------------------------------

def _run(pack, x: torch.Tensor, with_grad: bool, bf16: bool):
    flat = x.reshape(-1, 3)
    if flat.is_cuda:
        if pack.kind == "siren":
            val, grad = siren_forward_cuda(pack, flat.contiguous(), with_grad)
        else:
            val, grad = igr_forward_cuda(pack, flat.contiguous(), with_grad,
                                         bf16)
        return (val, grad) if with_grad else val
    if flat.device.type != "cpu":
        raise ValueError(f"the fused MLP runs on CUDA or CPU, not {flat.device}")
    _check_points(flat, pack)
    if pack.kind == "siren":
        return (siren_sdf_and_grad_plain(pack, flat) if with_grad
                else siren_sdf_plain(pack, flat))
    return (igr_sdf_and_grad_plain(pack, flat, bf16) if with_grad
            else igr_sdf_plain(pack, flat, bf16))


class _FusedSDF:
    """`sdf(x)`: (..., 3) -> (...), on frozen weights, no autograd.

    Attributes:
      sdf_and_grad(x): (..., 3) -> ((...), (..., 3)).
      fused_ray_sampler: the in-kernel dense sampler on the same weights.
      fused_trace_stepper: the in-kernel fused-backstep march.
      precision: "f32" or "bf16".
    """
    precision = "f32"

    def _bf16(self) -> bool:
        return self.precision == "bf16"

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _run(self.pack, x, False, self._bf16()).reshape(x.shape[:-1])

    @torch.no_grad()
    def sdf_and_grad(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        v, g = _run(self.pack, x, True, self._bf16())
        return v.reshape(x.shape[:-1]), g.reshape(x.shape)


class FusedSirenSDF(_FusedSDF):
    """The fused SIREN callable (f32). Its march raises: the SIREN instance
    of the march kernel comes with the next slice."""

    def __init__(self, field: SirenField):
        self.pack = SirenPack(field)
        self.fused_ray_sampler = FusedSampler(
            self.pack, lambda p: siren_sdf_plain(self.pack, p))
        self.fused_trace_stepper = TraceStepper(self.pack, False)


class FusedIgrSDF(_FusedSDF):
    """The fused IGR callable at `precision`. Its sampler sweeps coarse at
    bf16 from the same pack (the bf16-rounded weights), so for the f32
    callable `coarse_sweep` equals a sweep with the bf16 callable of the
    same field."""

    def __init__(self, field: SDFField, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.precision = precision
        self.pack = IgrPack(field)
        bf16 = precision == "bf16"
        self.fused_ray_sampler = FusedSampler(
            self.pack, lambda p: igr_sdf_plain(self.pack, p, bf16),
            sdf_plain_coarse=lambda p: igr_sdf_plain(self.pack, p, True),
            fine_bf16=bf16)
        self.fused_trace_stepper = TraceStepper(
            self.pack, bf16, lambda p: igr_sdf_plain(self.pack, p, bf16))


class PlainIgrSDF:
    """The plain version of a fused IGR callable's value, on any device
    (`igr_sdf_plain`). It carries no sampler and no march, so `ray_trace`
    takes its plain routes with it: the all-plain reference the kernels
    are held against."""

    def __init__(self, pack: IgrPack, precision: str = "f32"):
        self.pack = pack
        self.precision = precision

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        v = igr_sdf_plain(self.pack, x.reshape(-1, 3), self.precision == "bf16")
        return v.reshape(x.shape[:-1])


def make_fused_siren_sdf(field: SirenField, precision: str = "f32"
                         ) -> FusedSirenSDF:
    if precision != "f32":
        raise NotImplementedError(f"the fused SIREN {precision!r} mode "
                                  f"{NEXT_SLICE}")
    return FusedSirenSDF(field)


def make_fused_igr_sdf(field: SDFField, precision: str = "f32"
                       ) -> FusedIgrSDF:
    return FusedIgrSDF(field, precision)


def make_fused_sdf_fn(field, precision: str = "f32"):
    """The fused callable for a supported field, or None (pallas_mlp.py:
    383-410): a `SirenField` (f32 only; its bf16 mode raises
    NotImplementedError until the next slice) or an `SDFField` without
    positional encoding. An `SDFField` with `num_frequencies > 0` has no
    kernel in either package, so this returns None for it and the caller
    traces the plain field."""
    if isinstance(field, SirenField):
        return make_fused_siren_sdf(field, precision)
    if isinstance(field, SDFField) and field.num_frequencies <= 0:
        return make_fused_igr_sdf(field, precision)
    return None
