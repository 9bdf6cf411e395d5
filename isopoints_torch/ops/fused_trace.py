"""In-kernel sphere-trace march: a hand-written CUDA kernel and its plain
version.

Replaces `make_trace_stepper` / `_march_kernel` of
isopoints_tpu/ops/pallas_trace.py (:43, :103) for the SIREN and the IGR
field. The kernel (csrc/fused_trace.cu) marches a fixed count of
fused-backstep iterations (`body_fused`, models/raytracing.py) per ray,
both fronts of 64 rays evaluated as one 128-row tile of the fused MLP
kernels' tensor-core tile per iteration, so it equals the loop over the
fused callable bit for bit. A fixed count equals the while loop, because a finished ray takes
zero moves, and it needs no host synchronisation.

`TraceStepper` is what a fused callable's `.fused_trace_stepper` holds:

    stepper(cam (..., 3), dirs (..., 3), state10, n_iters, thr,
            line_search_step, line_step_iters, gate_end_front) -> state10'

state10 = (acc_s, acc_e, sdf_s, sdf_e, un_s, un_e, bk_s, bk_e, cur_s,
cur_e), un_* bool, bk_* int32, the rest float32, all shaped (...). A CUDA
input launches the kernel or raises; a CPU input runs the plain version,
`models/raytracing.march_plain`: the port's `body_fused` loop over the
callable's plain value function for the same fixed count.
"""

import ctypes
import functools
from typing import Callable, Tuple

import torch

from isopoints_torch.ops import _build

KERNEL = _build.LaunchCount("trace_march")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float

_DTYPES = (torch.float32,) * 4 + (torch.bool,) * 2 + (torch.int32,) * 2 \
    + (torch.float32,) * 2


@functools.lru_cache(maxsize=None)
def _lib(wide: bool = False) -> ctypes.CDLL:
    """The march's library; `wide`: its instances above
    `_build.NARROW_MAX`, csrc/fused_trace_wide.cu."""
    lib = _build.load("fused_trace_wide" if wide else "fused_trace")
    lib.trace_march.argtypes = ([_P] * 12 + [_I, _I, _F, _F, _I, _I]
                                + [_P] * 7 + [_I, _I, _U, _I, _F, _F, _I, _I, _P])
    lib.trace_march.restype = _I
    return lib


def march_cuda(pack, cam: torch.Tensor, dirs: torch.Tensor, state10,
               n_iters: int, thr: float, line_search_step: float,
               line_step_iters: int, gate_end_front: bool,
               bf16: bool = False) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel: cam, dirs (R, 3) and the state (R,) on the
    weights' CUDA device. Returns the new state (fresh tensors)."""
    r = dirs.shape[0]
    for name, t in (("cam", cam), ("dirs", dirs)):
        if (t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous()
                or tuple(t.shape) != (r, 3) or t.device != pack.device):
            raise ValueError(f"{name}: the march kernel takes contiguous "
                             f"float32 (R, 3) tensors on {pack.device}")
    out = []
    for i, (s, dt) in enumerate(zip(state10, _DTYPES)):
        if s.dtype != dt or tuple(s.shape) != (r,) or s.device != pack.device:
            raise ValueError(f"state[{i}]: expected {dt} ({r},) on "
                             f"{pack.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
        out.append(s.clone(memory_format=torch.contiguous_format))
    if n_iters < 0 or line_step_iters < 0:
        raise ValueError("n_iters and line_step_iters must be >= 0")
    ptrs = pack.mma_net(bool(bf16))[1][:7]
    lib = _lib(pack.arch_args()[0] > _build.NARROW_MAX)
    stream = torch.cuda.current_stream(dirs.device).cuda_stream
    KERNEL.launches += 1
    err = lib.trace_march(cam.data_ptr(), dirs.data_ptr(),
                          *(s.data_ptr() for s in out), r, int(n_iters),
                          float(thr), float(1.0 - line_search_step),
                          int(line_step_iters), int(bool(gate_end_front)),
                          *ptrs, *pack.arch_args(), *pack.omegas(),
                          int(pack.kind == "siren"), int(bool(bf16)), stream)
    _build.check_launch(lib, err, "trace_march")
    return tuple(out)


class TraceStepper:
    """In-kernel fused-backstep march over a SirenPack or an IgrPack (see
    the module docstring); `sdf_plain` is the callable's plain value
    function."""

    def __init__(self, pack, bf16: bool, sdf_plain: Callable):
        self.pack = pack
        self.bf16 = bf16
        self.sdf_plain = sdf_plain

    @torch.no_grad()
    def __call__(self, cam, dirs, state10, n_iters: int, thr: float,
                 line_search_step: float, line_step_iters: int,
                 gate_end_front: bool):
        shp = state10[0].shape
        cam2 = torch.broadcast_to(cam, dirs.shape).reshape(-1, 3)
        drs = dirs.reshape(-1, 3)
        flat = [s.reshape(-1) for s in state10]
        if drs.is_cuda:
            out = march_cuda(self.pack, cam2.contiguous(), drs.contiguous(),
                             flat, n_iters, thr, line_search_step,
                             line_step_iters, gate_end_front, self.bf16)
        elif drs.device.type == "cpu":
            from isopoints_torch.models.raytracing import march_plain
            out = march_plain(self.sdf_plain, cam2, drs, flat, n_iters, thr,
                              line_search_step, line_step_iters,
                              gate_end_front)
        else:
            raise ValueError(f"the march runs on CUDA or CPU, not {drs.device}")
        return tuple(o.reshape(shp) for o in out)
