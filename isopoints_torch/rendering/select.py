"""Splat candidate selection, the coarse stage of the tiled rasterizer: a
hand-written CUDA kernel and its plain version.

The kernel (csrc/splat_select.cu) replaces `_select_kernel` of
isopoints_tpu/rendering/pallas_select.py (:73, wrapper
`select_candidates_pallas` :258): per strip of tiles, the
`max_points_per_strip` front-most splats overlapping it, then per tile the
`max_points_per_tile` front-most of those, by radix select on the depth
bits and warp-ballot compaction. A thread-block cluster of 8 blocks
takes a strip: the blocks split its splats, meet through distributed
shared memory, each hold the strip's list and take nt/8 of its tiles. Bound on an H100: bytes (the (P,) inputs and the (nt², M)
candidate table).

The plain version is the XLA path's `_tile_candidates`
(isopoints_tpu/rendering/rasterizer.py:293-330) over every tile row, with
`lax.top_k` as a stable descending sort. Both give the same candidate SET
per tile and the same overflow count; the kernel lists a tile's
candidates in index order, the plain version by depth.

`select_candidates` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors. The wrapper is the launch and one `torch.sum`
(the per-tile overflow counts the kernel writes, summed per cloud): it
reads the splat attributes through their strides and `valid` as the bytes
of its bool storage, and the kernel writes the candidates as int64 and the
flags into a bool tensor's storage.
"""

import ctypes
import functools
from typing import Tuple

import torch

from isopoints_torch.ops import _build
from isopoints_torch.utils import top_k

KERNEL = _build.LaunchCount("splat_select")
_BIG = 1e10

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("splat_select")
    lib.select_candidates.argtypes = [_P] * 7 + [_I] * 7 + [_F] * 2 + [_P] * 4
    lib.select_candidates.restype = _I
    return lib


def pixel_ndc(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Pixel-center NDC coordinate with the axis flip:
    ndc(i) = (S − 2i − 1)/S (rasterizer.py:287-290), divided as XLA
    divides by a constant: times the float32 reciprocal of S."""
    return (size - 2.0 * idx.float() - 1.0) * (1.0 / size)


def tile_centers(S: int, T: int, device=None) -> torch.Tensor:
    """NDC center of each tile row/column (nt,): the midpoint of its first
    and last pixel centers."""
    xs = pixel_ndc(torch.arange(S, device=device), S)
    return 0.5 * (xs[::T] + xs[T - 1::T])


def tile_candidates(px, py, z, rx, ry, valid, cy: torch.Tensor,
                    cx: torch.Tensor, half: float, m: int,
                    strip_cap: int = 0):
    """The `m` front-most splats whose bbox touches each tile of one tile
    row, for a batch of clouds (rasterizer.py:293-330). Per-splat inputs
    (B, P); cy () the row's center, cx (nt,) the tiles' centers. With
    `strip_cap` > 0 and P > strip_cap, a strip-level selection narrows to
    the front-most `strip_cap` splats overlapping the row first. Returns
    (cand_idx (B, nt, m), cand_ok (B, nt, m), overflow (B,))."""
    b, p = px.shape
    if strip_cap and p > strip_cap:
        strip = (torch.abs(py - cy) <= (ry + half)) & valid
        strip_ovf = torch.clamp(torch.sum(strip.long(), dim=-1) - strip_cap, min=0)
        neg_sz, sidx = top_k(torch.where(strip, -z, -_BIG), strip_cap)
        g = lambda v: torch.gather(v, 1, sidx)
        cand_l, ok_l, tile_ovf = tile_candidates(
            g(px), g(py), g(z), g(rx), g(ry), neg_sz > -_BIG * 0.5, cy, cx,
            half, m)
        cand = torch.gather(sidx, 1, cand_l.reshape(b, -1)).reshape(cand_l.shape)
        return cand, ok_l, strip_ovf + tile_ovf
    overlap_y = torch.abs(py - cy) <= (ry + half)                       # (B, P)
    overlap = overlap_y[:, None, :] & (
        torch.abs(px[:, None, :] - cx[None, :, None]) <= (rx[:, None, :] + half))
    ok = overlap & valid[:, None, :]                                     # (B, nt, P)
    ovf = torch.sum(torch.clamp(torch.sum(ok.long(), dim=-1) - m, min=0), dim=-1)
    neg_z, cand_idx = top_k(torch.where(ok, -z[:, None, :], -_BIG), m)
    return cand_idx, neg_z > -_BIG * 0.5, ovf


def select_candidates_plain(px, py, z, rx, ry, valid, S: int, T: int,
                            R: int, M: int):
    """Plain version: `tile_candidates` for every tile row. Returns
    (cand_idx (B, nt², M) int64, cand_ok (B, nt², M) bool, overflow (B,))."""
    nt = S // T
    half = float(T - 1) / S
    cx = tile_centers(S, T, px.device)
    idx, ok, ovf = [], [], 0
    for ti in range(nt):
        ci, co, ov = tile_candidates(px, py, z, rx, ry, valid, cx[ti], cx, half,
                                     M, strip_cap=R)
        idx.append(ci)
        ok.append(co)
        ovf = ovf + ov
    return torch.cat(idx, 1), torch.cat(ok, 1), ovf


def select_candidates_cuda(px, py, z, rx, ry, valid, S: int, T: int, R: int,
                           M: int):
    """Launch the CUDA kernel; same arguments and results as the plain
    version (candidate order aside)."""
    ins = (px, py, z, rx, ry, valid)
    for t in ins:
        if not t.is_cuda or t.shape != px.shape or t.device != px.device:
            raise ValueError("select_candidates_cuda takes (B, P) CUDA tensors "
                             "on one device")
    if any(t.dtype != torch.float32 for t in ins[:5]) or valid.dtype != torch.bool:
        raise TypeError("select_candidates_cuda takes float32 splat attributes "
                        "and a bool valid mask")
    b, p = px.shape
    nt = S // T
    r = min(R, p) if R else p
    if not 1 <= M <= r:
        raise ValueError(f"tile capacity M={M} must be in [1, strip capacity {r}]")
    ins = ins[:5] + (valid.view(torch.uint8),)
    strides = (ctypes.c_longlong * 12)(*(t.stride(0) for t in ins),
                                       *(t.stride(1) for t in ins))
    dev = px.device
    cidx = torch.empty((b, nt * nt, M), dtype=torch.int64, device=dev)
    cok = torch.empty((b, nt * nt, M), dtype=torch.bool, device=dev)
    ovf = torch.empty((b, nt * nt), dtype=torch.int64, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launches += 1
    err = lib.select_candidates(*(t.data_ptr() for t in ins), strides, b, p, S,
                                T, nt, r, M, 1.0 / S, float(T - 1) / S,
                                cidx.data_ptr(), cok.data_ptr(), ovf.data_ptr(),
                                stream)
    _build.check_launch(lib, err, "splat_select")
    return cidx, cok, torch.sum(ovf, dim=-1)


def select_candidates(px, py, z, rx, ry, valid, S: int, T: int, R: int,
                      M: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile candidate selection for B clouds (per-splat inputs (B, P);
    `valid` must include z >= 0). R = strip capacity (0 = none), M = tile
    capacity. The kernel for CUDA tensors, the plain version for CPU."""
    if px.is_cuda:
        return select_candidates_cuda(px, py, z, rx, ry, valid, S, T, R, M)
    if px.device.type != "cpu":
        raise ValueError(f"select_candidates runs on CUDA or CPU, not {px.device}")
    return select_candidates_plain(px, py, z, rx, ry, valid, S, T, R, M)
