"""Fused SDF-MLPs: hand-written CUDA kernels and their plain versions.

SIREN. Replaces `make_fused_siren_sdf` / `_siren_kernel` of
isopoints_tpu/ops/pallas_mlp.py (:250, :309) in both of its modes. The
kernel (csrc/fused_mlp.cu on csrc/mlp_mma.cuh, the tensor-core tile the
IGR kernels use, with the sine as its activation) evaluates the whole
SIREN stack per tile with the activations in shared memory, the hidden
products on the tensor cores, the first layer, head and sine epilogue in
f32 on the CUDA cores, and with `with_grad` also the input gradient as
three forward-mode tangent rows per point. Two precisions, as for IGR
below: `"f32"` as 3xTF32 (the weights split once on the host,
`SirenPack.mma_net`), and `"bf16"`, JAX's `bf16` mode: every matmul
operand (x, the activations and tangents, every layer's weights,
the head's included) rounded to bf16, the products exact in f32 and
accumulated in f32, the biases f32. A launch takes tiles of 128 rows, or of
32 where 128-row tiles would leave half the SMs idle. Its bound on an H100:
2(3H + L·H² + H) FLOP per value eval (~0.40 MFLOP at 3×256), about 4x
that with the gradient, in bf16 over the bf16 tensor-core peak and in
f32 as three tf32 passes over the tf32 peak.

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

Widths. The kernels have instances at every multiple of 32 up to 256 and
at 384 and 512 (csrc/mlp_mma.cuh "Widths"; the two wide ones in the
`_wide` libraries, on csrc/mlp_wide.cuh's tile, which reads the hidden
layers from `wide_layout`'s stage pack); a pack zero-pads its field to the
smallest instance at or above its width (`kernel_width`), as JAX's kernels
take any width, and a field wider than 512 raises ValueError on a CUDA
tensor.

A CUDA input launches the kernel or raises; a CPU input runs the plain
version (`siren_sdf_plain`, `siren_sdf_and_grad_plain`, `igr_sdf_plain`,
`igr_sdf_and_grad_plain`, each in f32 or bf16): the same function in
PyTorch ops, which is what the CPU tests compare with JAX. `PlainSDF` is
a callable of the plain version alone, on any device.
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

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib(wide: bool = False) -> ctypes.CDLL:
    """The SIREN kernel's library; `wide`: its instances above
    `_build.NARROW_MAX`, csrc/fused_mlp_wide.cu."""
    lib = _build.load("fused_mlp_wide" if wide else "fused_mlp")
    lib.siren_forward.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _F, _F, _I, _P, _P, _P]
    lib.siren_forward.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _igr_lib(wide: bool = False) -> ctypes.CDLL:
    """The IGR kernel's library; `wide` as in `_lib`."""
    lib = _build.load("fused_igr_wide" if wide else "fused_igr")
    lib.igr_forward.argtypes = [_P, _I] + [_P] * 7 + [_I, _I, _U, _I, _I,
                                                      _P, _P, _P]
    lib.igr_forward.restype = _I
    return lib


# the widths of the kernels' instances (csrc/mlp_mma.cuh `MLP_MMA_WIDTHS`)
KERNEL_WIDTHS = tuple(range(32, 257, 32)) + (384, 512)
MAX_WIDTH = KERNEL_WIDTHS[-1]


def kernel_width(h: int) -> int:
    """The width of the kernel instance that runs a field of width `h`: the
    smallest instance at or above it, to which the pack zero-pads the
    weights. JAX's kernels take any width (their weights are whole VMEM
    blocks, pallas_mlp.py:348, :535); above the widest instance the CUDA
    kernels raise."""
    for w in KERNEL_WIDTHS:
        if w >= h:
            return w
    raise ValueError(f"the CUDA MLP kernels take a hidden width up to "
                     f"{MAX_WIDTH}, got {h}")


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


def wide_layout(wh: torch.Tensor, wh_lo: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """The hidden layers (L, H, H) as (out, in), bf16 (`wh_lo` None) or the
    tf32 split (hi, lo), in the order the wide tile's weight stages read
    them (csrc/mlp_mma.cuh's wide instances, csrc/mlp_wide.cuh "Stages"):
    bytes [layer][column half][stage][part][H/16 row groups][K 16-byte
    halves][8 rows][16 bytes], a stage 64 bytes of K of the half's H/2 rows
    (8 values of hi then of lo in f32, 32 bf16 values), so that a block's
    weight stream is contiguous and each stage is wgmma's K-major operand
    without swizzle. Flat uint8."""
    n_l, h, _ = wh.shape
    nb = h // 2
    if wh_lo is None:
        w = wh.view(torch.int16).reshape(n_l, 2, nb // 8, 8, h // 32, 4, 8)
        w = w.permute(0, 1, 4, 2, 5, 3, 6)       # l, half, stage, group, K half, row, value
    else:
        w = torch.stack([wh, wh_lo]).view(torch.int32).reshape(
            2, n_l, 2, nb // 8, 8, h // 8, 2, 4)
        w = w.permute(1, 2, 5, 0, 3, 6, 4, 7)    # l, half, stage, part, group, K half, row, value
    return w.contiguous().view(torch.uint8).reshape(-1)


def _pointers(tensors: List[Optional[torch.Tensor]], h: int
              ) -> Tuple[List[Optional[int]], Optional[torch.Tensor]]:
    """The seven pointers the launchers take for the tile's tensors, and
    above `_build.NARROW_MAX` the wide stage pack they point to in place of
    wh and wh_lo (`wide_layout`; kept alive by the caller)."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    if h <= _build.NARROW_MAX:
        return ptrs, None
    wide = wide_layout(tensors[2], tensors[3])
    ptrs[2:4] = [wide.data_ptr() if wide.numel() else None, None]
    return ptrs, wide


def _mma_tensors(w0, b0, mid_ws, mid_bs, wout, bout, h: int, bf16: bool,
                 device) -> List[Optional[torch.Tensor]]:
    """The tensor-core tile's seven tensors (mlp_mma::Net): w0, b0, wh and
    wh_lo, the hidden layers (L, H, H) as (out, in), the K-major B operand,
    as `torch.bfloat16` and None in bf16 or as the tf32 split
    (`tf32_split`) in f32, bh (L, H), wout (H,), bout (1,)."""
    f32 = dict(dtype=torch.float32, device=device)
    wh = torch.stack(mid_ws) if mid_ws else torch.zeros((0, h, h), **f32)
    bh = torch.stack(mid_bs) if mid_bs else torch.zeros((0, h), **f32)
    his = (wh.to(torch.bfloat16), None) if bf16 else tf32_split(wh)
    return [None if t is None else t.contiguous() for t in
            (w0, b0, *his, bh, wout.reshape(-1), bout)]


class SirenPack:
    """Detached SIREN weights: the (out, in) layers for the plain versions
    (f32, and bf16-rounded for the bf16 mode), and on first CUDA use the
    tensor-core tile's layout `mma_net`, which the fused MLP, the sampler
    and the march read."""
    kind = "siren"

    def __init__(self, field: SirenField):
        if not field.sdf_only:
            raise ValueError("the fused SIREN path needs a linear SDF head "
                             "alone and no latent code (pallas_mlp.py:398-400)")
        with torch.no_grad():
            self.ws = tuple(l.weight.detach().clone() for l in field.layers)
            self.bs = tuple(l.bias.detach().clone() for l in field.layers)
        self.ws_bf16 = tuple(_round_bf16(w) for w in self.ws)
        self.hidden = field.hidden_size
        self.n_hidden = field.n_layers
        self.omega_first = float(field.first_omega_0)
        self.omega_hidden = float(field.hidden_omega_0)
        self.device = self.ws[0].device
        self._mma_nets = {}
        self._wide = {}

    def weights(self, bf16: bool) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        return (self.ws_bf16 if bf16 else self.ws), self.bs

    def arch_args(self) -> Tuple[int, int, int, int]:
        """The kernel's width (`kernel_width`), n_hidden, skip mask (none),
        final_tanh (none)."""
        return (kernel_width(self.hidden), self.n_hidden, 0, 0)

    def omegas(self) -> Tuple[float, float]:
        return (self.omega_first, self.omega_hidden)

    def mma_net(self, bf16: bool = False) -> Tuple[List[torch.Tensor], Tuple]:
        """(tensors kept alive, args) of the tensor-core tile (mlp_mma.cuh)
        at the kernel's width Hk (`kernel_width`, the field's zero-padded):
        w0 (Hk, 3), b0 (Hk,), wh and wh_lo, the hidden layers (L, Hk, Hk)
        as (out, in), the K-major B operand, bh (L, Hk), wout (Hk,), bout
        (1,); args are their seven pointers, then Hk, n_hidden, ω₀, ω
        (above width 256 the wh pointer is the `wide_layout` pack's and
        wh_lo's None). A padded unit is sin(0) = 0 and its weights out are
        zero, so the padding is exact. In f32
        wh and wh_lo are the tf32 split (`tf32_split`) of the weights; in
        bf16 wh is `torch.bfloat16`, wh_lo None, and w0 and wout are the
        bf16-rounded weights (every matmul operand of JAX's bf16 mode is
        bf16; the biases stay f32). The bf16 weights are the bf16 rounding
        of the same weights the f32 mode splits, so a coarse sweep of the
        f32 callable equals a sweep with the bf16 callable (JAX's "hi half"
        rule, pallas_sampler.py:21-26)."""
        if bf16 not in self._mma_nets:
            h = self.hidden
            hk = kernel_width(h)
            ws, bs = self.weights(bf16)
            for t in ws + bs:
                if t.dtype != torch.float32:
                    raise TypeError("the CUDA SIREN kernel takes float32 weights")
            ws = [F.pad(w, (0, (hk - h) * (i > 0), 0, (hk - h) * (i < len(ws) - 1)))
                  for i, w in enumerate(ws)]
            bs = [F.pad(b, (0, (hk - h) * (i < len(bs) - 1))) for i, b in enumerate(bs)]
            tensors = _mma_tensors(ws[0], bs[0], ws[1:-1], bs[1:-1], ws[-1],
                                   bs[-1], hk, bf16, self.device)
            ptrs, self._wide[bf16] = _pointers(tensors, hk)
            self._mma_nets[bf16] = (tensors, tuple(ptrs) + (
                hk, self.n_hidden, self.omega_first, self.omega_hidden))
        return self._mma_nets[bf16]


def _layers(pack, bf16: bool, exact_sums: bool):
    """A pack's weights and the plain versions' operand rounding and sums:
    bf16 rounding of every matmul operand when `bf16`, float64 sums rounded
    once when `exact_sums`."""
    ws, bs = pack.weights(bf16)
    rnd = _round_bf16 if bf16 else (lambda a: a)
    lin = _linear_exact if exact_sums else F.linear
    return ws, bs, rnd, lin


def siren_sdf_plain(pack: SirenPack, x: torch.Tensor, bf16: bool = False,
                    exact_sums: bool = False) -> torch.Tensor:
    """Plain version of the value kernel, x (N, 3) -> (N,): sin(ω(xW + b))
    layers and a linear head, every matmul operand (x, the activations, the
    weights) rounded to bf16 when `bf16` (pallas_mlp.py:78-97), the biases
    f32. `exact_sums` forms each product's sum in float64 and rounds it
    once: the reference the bf16 mode is held to on the card. The sine is
    the accurate one in both modes, as in the kernel; JAX's bf16/f32x3
    modes take a range-reduced polynomial within ~1e-7 of it
    (pallas_mlp.py:222-248)."""
    ws, bs, rnd, lin = _layers(pack, bf16, exact_sums)
    h = torch.sin(pack.omega_first * lin(rnd(x), ws[0], bs[0]))
    for w, b in zip(ws[1:-1], bs[1:-1]):
        h = torch.sin(pack.omega_hidden * lin(rnd(h), w, b))
    return lin(rnd(h), ws[-1], bs[-1])[..., 0]


def siren_sdf_and_grad_plain(pack: SirenPack, x: torch.Tensor,
                             bf16: bool = False, exact_sums: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the value+grad kernel: forward-mode tangents
    J ← (J Wᵀ)·ω cos(ω z), as the kernel carries them, the tangent
    operands rounded like the values in bf16 (`exact_sums` as in
    `siren_sdf_plain`). x (N, 3) -> ((N,), (N, 3))."""
    ws, bs, rnd, lin = _layers(pack, bf16, exact_sums)
    a = pack.omega_first * lin(rnd(x), ws[0], bs[0])
    h = torch.sin(a)
    jac = (pack.omega_first * torch.cos(a))[:, None, :] * ws[0].t()[None]
    for w, b in zip(ws[1:-1], bs[1:-1]):
        a = pack.omega_hidden * lin(rnd(h), w, b)
        h = torch.sin(a)
        jac = (pack.omega_hidden * torch.cos(a))[:, None, :] * lin(rnd(jac), w)
    out = lin(rnd(h), ws[-1], bs[-1])[..., 0]
    grad = lin(rnd(jac), ws[-1])[..., 0]
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


def siren_forward_cuda(pack: SirenPack, x: torch.Tensor, with_grad: bool,
                       bf16: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel on (N, 3) contiguous float32 CUDA points."""
    _check_points(x, pack)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("siren_forward_cuda takes a contiguous CUDA tensor")
    _, wargs = pack.mma_net(bf16)
    lib = _lib(wargs[7] > _build.NARROW_MAX)
    val, grad = _outputs(x, with_grad)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launches += 1
    err = lib.siren_forward(x.data_ptr(), x.shape[0], *wargs, int(bf16),
                            val.data_ptr(),
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
        if field.num_frequencies > 0 or field.out_dim != 1:
            raise ValueError("the fused IGR path needs num_frequencies <= 0 "
                             "(raw xyz input) and the SDF head alone, as "
                             "pallas_mlp.py:502-503 asserts")
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
        self._wide = {}

    def weights(self, bf16: bool) -> Tuple[Tuple[torch.Tensor, ...], ...]:
        return (self.ws_bf16 if bf16 else self.ws), self.bs

    def omegas(self) -> Tuple[float, float]:
        return (0.0, 0.0)   # SIREN's; the IGR tile reads none

    def skip_mask(self) -> int:
        return sum(1 << l for l in self.skip_in if 0 <= l < self.n_layers)

    def arch_args(self) -> Tuple[int, int, int, int]:
        """The kernel's width (`kernel_width`), n_hidden, skip mask,
        final_tanh for the launchers."""
        return (kernel_width(self.hidden), self.n_layers - 2, self.skip_mask(),
                int(self.final_tanh))

    def mma_net(self, bf16: bool
                ) -> Tuple[List[torch.Tensor], List[Optional[int]]]:
        """(tensors kept alive, pointers) of the tensor-core tile's layout
        (mlp_mma.cuh), which the fused IGR kernel, the IGR sampler and the
        march read, at the kernel's width Hk (`kernel_width`): w0 (Hk, 3),
        b0 (Hk,), wh, wh_lo, bh (L, Hk), wout (Hk,), bout (1,), each layer
        zero-padded to Hk outputs and Hk inputs. The hidden layers stay
        (L, Hk, Hk) as (out, in), the K-major B operand: in bf16 as
        `torch.bfloat16` (the values are bf16 already), in f32 as the tf32
        split `tf32_split`, hi in wh and lo in wh_lo (None in bf16). Above
        width 256 the pointers carry the `wide_layout` pack of wh and wh_lo
        in wh's place (and None in wh_lo's), which the wide tile reads.

        The skip. JAX's concat([h, x]) / √2 puts the point in columns
        H−3..H−1 of the row; the kernel writes it into the last three
        columns of its padded row, Hk−3..Hk−1 (`store_col`), so a layer
        in `skip_in` takes JAX's input columns H−3..H−1 at Hk−3..Hk−1.

        Padding is exact only where nothing reads a padded unit: a padded
        IGR unit has z = 0 and holds softplus(0)/β = log 2/100, not 0 (a
        SIREN unit holds sin 0 = 0). So every padded input column of the
        next layer, and of the head, is zero, and with it the unit's
        product; its tangent rows are σ(0)·0 = 0."""
        if bf16 not in self._mma_nets:
            h, nl = self.hidden, self.n_layers
            hk = kernel_width(h)
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

            def pad(l, rows):
                """Layer l zero-padded to `rows` outputs and, past the first
                layer, to Hk inputs, the point's columns of a skip last."""
                w, b = ws[l], bs[l]
                if l > 0:
                    wide = w.new_zeros((w.shape[0], hk))
                    split = h - 3 if l in self.skip_in else h
                    wide[:, :split] = w[:, :split]
                    wide[:, hk - (h - split):] = w[:, split:]
                    w = wide
                out = w.shape[0]
                return F.pad(w, (0, 0, 0, rows - out)), F.pad(b, (0, rows - out))

            w0, b0 = pad(0, hk)
            mid = [pad(l, hk) for l in range(1, nl - 1)]
            wout, bout = pad(nl - 1, 1)
            tensors = _mma_tensors(w0, b0, [w for w, _ in mid], [b for _, b in mid],
                                   wout, bout, hk, bf16, self.device)
            ptrs, self._wide[bf16] = _pointers(tensors, hk)
            self._mma_nets[bf16] = (tensors, ptrs)
        return self._mma_nets[bf16]


def _linear_exact(a: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.linear with each sum formed in float64 and rounded once to
    float32."""
    return F.linear(a.double(), w.double(),
                    None if b is None else b.double()).float()


def igr_sdf_plain(pack: IgrPack, x: torch.Tensor, bf16: bool = False,
                  exact_sums: bool = False) -> torch.Tensor:
    """Plain version of the value kernel, x (N, 3) -> (N,): the JAX
    `_igr_kernel` value path, with every matmul operand rounded to bf16
    when `bf16`. `exact_sums` forms each product's sum in float64 and
    rounds it once (the float32 epilogue unchanged): the reference the
    tensor-core kernel's bf16 mode is held to, since its sums are neither
    exact nor float32 sums in this version's order."""
    ws, bs, rnd, lin = _layers(pack, bf16, exact_sums)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
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
    ws, bs, rnd, lin = _layers(pack, bf16, exact_sums)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
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
    _, ptrs = pack.mma_net(bf16)
    lib = _igr_lib(pack.arch_args()[0] > _build.NARROW_MAX)
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
        launch = siren_forward_cuda if pack.kind == "siren" else igr_forward_cuda
        val, grad = launch(pack, flat.contiguous(), with_grad, bf16)
        return (val, grad) if with_grad else val
    if flat.device.type != "cpu":
        raise ValueError(f"the fused MLP runs on CUDA or CPU, not {flat.device}")
    _check_points(flat, pack)
    return (_PLAIN_GRAD[pack.kind](pack, flat, bf16) if with_grad
            else _PLAIN[pack.kind](pack, flat, bf16))


_PLAIN = {"siren": siren_sdf_plain, "igr": igr_sdf_plain}
_PLAIN_GRAD = {"siren": siren_sdf_and_grad_plain, "igr": igr_sdf_and_grad_plain}


class _FusedSDF:
    """`sdf(x)`: (..., 3) -> (...), on frozen weights, no autograd.

    Made from a pack at `precision` ("f32" or "bf16"). Attributes:
      sdf_and_grad(x): (..., 3) -> ((...), (..., 3)).
      fused_ray_sampler: the in-kernel dense sampler on the same pack. It
        sweeps coarse at bf16 from the same pack (the bf16-rounded
        weights), so for the f32 callable `coarse_sweep` equals a sweep
        with the bf16 callable of the same field.
      fused_trace_stepper: the in-kernel fused-backstep march.
      precision: "f32" or "bf16".
    """

    def __init__(self, pack, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.precision = precision
        self.pack = pack
        bf16 = precision == "bf16"
        plain = _PLAIN[pack.kind]
        self.fused_ray_sampler = FusedSampler(
            pack, lambda p: plain(pack, p, bf16),
            sdf_plain_coarse=lambda p: plain(pack, p, True), fine_bf16=bf16)
        self.fused_trace_stepper = TraceStepper(
            pack, bf16, lambda p: plain(pack, p, bf16))

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
    """The fused SIREN callable at `precision`."""

    def __init__(self, field: SirenField, precision: str = "f32"):
        super().__init__(SirenPack(field), precision)


class FusedIgrSDF(_FusedSDF):
    """The fused IGR callable at `precision`."""

    def __init__(self, field: SDFField, precision: str = "f32"):
        super().__init__(IgrPack(field), precision)


class PlainSDF:
    """The plain version of a fused callable's value and gradient, on any
    device (`siren_sdf_plain` / `igr_sdf_plain` and their gradients). It
    carries no sampler and no march, so `ray_trace` takes its plain routes
    with it: the all-plain reference the kernels are held against."""

    def __init__(self, pack, precision: str = "f32"):
        self.pack = pack
        self.precision = precision

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        v = _PLAIN[self.pack.kind](self.pack, x.reshape(-1, 3),
                                   self.precision == "bf16")
        return v.reshape(x.shape[:-1])

    @torch.no_grad()
    def sdf_and_grad(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        v, g = _PLAIN_GRAD[self.pack.kind](self.pack, x.reshape(-1, 3),
                                           self.precision == "bf16")
        return v.reshape(x.shape[:-1]), g.reshape(x.shape)


def make_fused_siren_sdf(field: SirenField, precision: str = "f32"
                         ) -> FusedSirenSDF:
    return FusedSirenSDF(field, precision)


def make_fused_igr_sdf(field: SDFField, precision: str = "f32"
                       ) -> FusedIgrSDF:
    return FusedIgrSDF(field, precision)


def make_fused_sdf_fn(field, precision: str = "f32"):
    """The fused callable for a supported field, or None (pallas_mlp.py:
    383-410): a `SirenField` with a linear SDF head alone and no code, or
    an `SDFField` with the SDF head alone and no positional encoding. Any
    other field has no kernel in either package, so this returns None for
    it and the caller traces the plain field."""
    if isinstance(field, SirenField) and field.sdf_only:
        return make_fused_siren_sdf(field, precision)
    if (isinstance(field, SDFField) and field.num_frequencies <= 0
            and field.out_dim == 1):
        return make_fused_igr_sdf(field, precision)
    return None
