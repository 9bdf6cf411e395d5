"""Splat rasterization, fine stage and the tile half of the zbuf backward:
hand-written CUDA kernels and their plain versions.

The kernel (csrc/splat_fine.cu) replaces `_fine_kernel` of
isopoints_tpu/rendering/pallas_splat.py (:42, wrapper
`rasterize_fine_pallas` :126): one block per T×T tile, one thread per
pixel. The block gathers its candidates from the (B, P, 9) per-splat table,
ranks them by (depth, global id) in shared memory, and each pixel walks
them in that order, appending its hits until K are kept or, once it has a
hit, until a candidate fails the depth-merging cut against the first (the
cut is monotone in depth, so no later candidate could pass it); a warp
skips the candidates whose boxes miss its pixels. Bound on an H100: bytes
(the candidates and their table rows read, the maps written).

The plain version is the fine half of the XLA path's `_rasterize_one`
(isopoints_tpu/rendering/rasterizer.py:364-399) on the tiled candidate
table: gather the candidates' attributes, score every (pixel, candidate)
pair, then K masked-min sweeps. Both break depth ties by the smaller
global point index (the JAX package gets the same order from its
candidate lists, whose equal depths come in index order), so neither
depends on the order of a tile's list, and both form
q = a·dx² + b·dx·dy + c·dy² with the fused multiply-adds XLA puts there.

`rasterize_fine` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors. Both take the per-splat table and the
selection's candidates as they come (the kernel writes idx as int64 and
`used` into a bool tensor's storage: the wrapper is the launch alone).
Outputs, per cloud and tile (all tiled): idx (global ids) / zbuf /
qvalue / slots (local candidate slots, which the zbuf backward reads)
(B, n_tiles, T², K), occupancy (B, n_tiles, T²) and per-candidate `used`
flags (B, n_tiles, M).

The zbuf backward's kernel (csrc/splat_zbuf_bwd.cu) replaces
`_zbuf_bwd_kernel` of the same file (:186, wrapper
`zbuf_backward_tile_pallas` :208) and the scatter to the points that
follows it in the JAX backward (isopoints_tpu/rendering/rasterizer.py
:633-643): per tile, the zbuf cotangent of every fragment summed into its
local candidate slot, read from the image-layout cotangent, and each hit
slot's sum added to its candidate's point. One block per tile; the slots
are grouped per warp with `__match_any_sync`, so the work is linear in
the fragments and the tile sums repeat bit for bit; one `atomicAdd` per
hit slot, none for the empty ones. Bound on an H100: bytes (8 per fragment
read, 8 per hit slot, 4 per point written). `zbuf_backward_points`
launches it for CUDA tensors and runs the plain version (the one-hot tile
sums, chunked by tiles, then `index_add_`) for CPU tensors.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from isopoints_torch.ops import _build
from isopoints_torch.rendering.select import pixel_ndc
from isopoints_torch.utils import fma

KERNEL = _build.LaunchCount("splat_fine")
ZBUF_KERNEL = _build.LaunchCount("splat_zbuf_bwd")
N_ATTRS = 9          # px, py, z, ea, eb, ec, rx, ry, cutoff
_BIG = 1e10

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("splat_fine")
    lib.rasterize_fine.argtypes = [_P] * 3 + [_I] * 8 + [_F] * 2 + [_P] * 7
    lib.rasterize_fine.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _zbuf_lib() -> ctypes.CDLL:
    lib = _build.load("splat_zbuf_bwd")
    lib.zbuf_backward_points.argtypes = [_P] * 3 + [_I] * 6 + [_P] * 3
    lib.zbuf_backward_points.restype = _I
    return lib


class FineResult(NamedTuple):
    idx: torch.Tensor     # (B, n_tiles, T², K) int64 global ids, -1 empty
    zbuf: torch.Tensor    # (B, n_tiles, T², K) view depth, -1 empty
    qvalue: torch.Tensor  # (B, n_tiles, T², K) conic value, -1 empty
    occ: torch.Tensor     # (B, n_tiles, T²) 0/1
    used: torch.Tensor    # (B, n_tiles, M) candidate picked by some pixel
    slots: torch.Tensor   # (B, n_tiles, T², K) int32 local slots, -1 empty


def _tile_pixels(tiles: torch.Tensor, S: int, T: int):
    """Pixel-center NDC (x, y) of every pixel of the given tiles:
    (len(tiles), T²) each, pixels in row-major order inside a tile."""
    nt = S // T
    lin = torch.arange(T * T, device=tiles.device)
    rows = (tiles // nt)[:, None] * T + lin[None] // T
    cols = (tiles % nt)[:, None] * T + lin[None] % T
    return pixel_ndc(cols, S), pixel_ndc(rows, S)


def _check_fine_inputs(table: torch.Tensor, cand_idx: torch.Tensor,
                       cand_ok: torch.Tensor):
    b, p, n_att = table.shape
    if n_att != N_ATTRS or cand_idx.dim() != 3 or cand_idx.shape[0] != b:
        raise ValueError(f"table (B, P, {N_ATTRS}) and cand_idx (B, n_tiles, M) "
                         f"must agree")
    if cand_ok.shape != cand_idx.shape:
        raise ValueError("cand_ok must be (B, n_tiles, M) as cand_idx")


def rasterize_fine_plain(table: torch.Tensor, cand_idx: torch.Tensor,
                         cand_ok: torch.Tensor, S: int, T: int, K: int,
                         depth_merging_threshold: float) -> FineResult:
    """Plain version, one tile row at a time. table (B, P, 9) per-splat
    attributes, cand_idx (B, n_tiles, M) point ids of each tile's
    candidates, cand_ok (B, n_tiles, M) bool."""
    _check_fine_inputs(table, cand_idx, cand_ok)
    b, n_tiles, m = cand_idx.shape
    attrs = torch.gather(table, 1, cand_idx.reshape(b, -1, 1).expand(-1, -1, N_ATTRS)
                         ).reshape(b, n_tiles, m, N_ATTRS)
    gid = cand_idx
    nt = S // T
    outs = []
    for lo in range(0, n_tiles, nt):
        a = attrs[:, lo:lo + nt]
        xf, yf = _tile_pixels(torch.arange(lo, min(lo + nt, n_tiles),
                                           device=attrs.device), S, T)
        c = lambda j: a[..., j][:, :, None, :]                  # (B, t, 1, M)
        dx = xf[None, :, :, None] - c(0)                         # (B, t, T², M)
        dy = yf[None, :, :, None] - c(1)
        q = fma(c(5) * dy, dy, fma(c(3) * dx, dx, c(4) * dx * dy))
        inside = ((torch.abs(dx) <= c(6)) & (torch.abs(dy) <= c(7))
                  & (q <= c(8)) & cand_ok[:, lo:lo + nt, None, :])
        g = torch.broadcast_to(gid[:, lo:lo + nt, None, :], q.shape)
        zwork = torch.where(inside, c(2), _BIG)
        occ = torch.any(inside, dim=-1).float()
        ids, zs, qs, sl = [], [], [], []
        z0 = None
        for _ in range(K):
            zmin = torch.amin(zwork, dim=-1, keepdim=True)
            # among equal depths the smaller global id; slots hold distinct ids
            gmin = torch.amin(torch.where(zwork == zmin, g, torch.iinfo(g.dtype).max),
                              dim=-1, keepdim=True)
            slot = torch.argmax(((zwork == zmin) & (g == gmin)).to(torch.uint8),
                                dim=-1, keepdim=True)
            zmin = zmin[..., 0]
            z0 = zmin if z0 is None else z0
            keep = (zmin < _BIG * 0.5) & ((zmin - z0) <= depth_merging_threshold)
            ids.append(torch.where(keep, torch.gather(g, -1, slot)[..., 0], -1))
            zs.append(torch.where(keep, zmin, -1.0))
            qs.append(torch.where(keep, torch.gather(q, -1, slot)[..., 0], -1.0))
            sl.append(torch.where(keep, slot[..., 0], -1))
            zwork = zwork.scatter(-1, slot, float("inf"))
        outs.append((torch.stack(ids, -1), torch.stack(zs, -1),
                     torch.stack(qs, -1), occ, torch.stack(sl, -1)))
    idx, zbuf, qv, occ, slots = (torch.cat(t, 1) for t in zip(*outs))
    used = torch.zeros((b, n_tiles, m + 1), dtype=torch.bool, device=attrs.device)
    used = used.scatter(-1, torch.where(slots >= 0, slots, m).reshape(b, n_tiles, -1),
                        True)[..., :m]
    return FineResult(idx, zbuf, qv, occ, used, slots.to(torch.int32))


def rasterize_fine_cuda(table: torch.Tensor, cand_idx: torch.Tensor,
                        cand_ok: torch.Tensor, S: int, T: int, K: int,
                        depth_merging_threshold: float) -> FineResult:
    """Launch the CUDA kernel; same arguments and results as the plain
    version."""
    for t in (table, cand_idx, cand_ok):
        if not t.is_cuda or t.device != table.device:
            raise ValueError("rasterize_fine_cuda takes CUDA tensors on one device")
    if (table.dtype != torch.float32 or cand_idx.dtype != torch.int64
            or cand_ok.dtype != torch.bool):
        raise TypeError("rasterize_fine_cuda takes a float32 table, int64 "
                        "candidate ids and bool flags")
    _check_fine_inputs(table, cand_idx, cand_ok)
    if K < 1 or T * T > 1024:
        raise ValueError("the CUDA fine stage takes K >= 1 and T*T <= 1024")
    b, p, _ = table.shape
    _, n_tiles, m = cand_idx.shape
    dev = table.device
    tab, ci = table.contiguous(), cand_idx.contiguous()
    ok = cand_ok.contiguous().view(torch.uint8)
    f32 = dict(dtype=torch.float32, device=dev)
    idx = torch.empty((b, n_tiles, T * T, K), dtype=torch.int64, device=dev)
    slots = torch.empty((b, n_tiles, T * T, K), dtype=torch.int32, device=dev)
    zbuf = torch.empty((b, n_tiles, T * T, K), **f32)
    qv = torch.empty((b, n_tiles, T * T, K), **f32)
    occ = torch.empty((b, n_tiles, T * T), **f32)
    used = torch.empty((b, n_tiles, m), dtype=torch.bool, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(b * n_tiles)
    err = lib.rasterize_fine(tab.data_ptr(), ci.data_ptr(), ok.data_ptr(), b, p,
                             n_tiles, m, S, T, S // T, K, 1.0 / S,
                             float(depth_merging_threshold),
                             idx.data_ptr(), zbuf.data_ptr(), qv.data_ptr(),
                             slots.data_ptr(), occ.data_ptr(), used.data_ptr(),
                             stream)
    _build.check_launch(lib, err, "splat_fine")
    return FineResult(idx, zbuf, qv, occ, used, slots)


def rasterize_fine(table: torch.Tensor, cand_idx: torch.Tensor,
                   cand_ok: torch.Tensor, S: int, T: int, K: int,
                   depth_merging_threshold: float) -> FineResult:
    """Fine stage over all tiles of B clouds: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if table.is_cuda:
        return rasterize_fine_cuda(table, cand_idx, cand_ok, S, T, K,
                                   depth_merging_threshold)
    if table.device.type != "cpu":
        raise ValueError(f"rasterize_fine runs on CUDA or CPU, not {table.device}")
    return rasterize_fine_plain(table, cand_idx, cand_ok, S, T, K,
                                depth_merging_threshold)


def to_tiles(x: torch.Tensor, T: int) -> torch.Tensor:
    """(B, S, S, C) image layout -> (B·nt², T², C) tiles, pixels row-major
    inside a tile (the layout of the fine stage's maps)."""
    b, S, c = x.shape[0], x.shape[1], x.shape[-1]
    nt = S // T
    return (x.reshape(b, nt, T, nt, T, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b * nt * nt, T * T, c))


def zbuf_backward_tile_plain(slots: torch.Tensor, gz: torch.Tensor,
                             M: int) -> torch.Tensor:
    """The tile half of the plain version: slots (n_tiles, T², K) int32
    local candidate slots (−1 empty), gz (n_tiles, T², K) zbuf cotangents
    -> (n_tiles, M) sums out[t, m] = Σ_{slots[t] == m} gz[t], as one-hot
    sums over chunks of tiles (≤ 2²⁴ one-hot entries each)."""
    n = slots.shape[0]
    sl = slots.reshape(n, -1)
    g = gz.reshape(n, -1)
    ids = torch.arange(M, device=slots.device)
    chunk = max(1, (1 << 24) // max(1, sl.shape[1] * M))
    out = [torch.where(sl[lo:lo + chunk, :, None] == ids, g[lo:lo + chunk, :, None],
                       0.0).sum(dim=1)
           for lo in range(0, n, chunk)]
    return torch.cat(out) if out else g.new_zeros((0, M))


def zbuf_backward_points_plain(slots: torch.Tensor, g_zbuf: torch.Tensor,
                               cand_idx: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version: slots (B, n_tiles, T², K) int32, g_zbuf (B, S, S, K)
    zbuf cotangents in image layout, cand_idx (B, n_tiles, M) point ids ->
    (B, P) z gradient: the per-tile slot sums, then one (B·n_tiles·M) → B·P
    `index_add_` over the candidates' point ids."""
    b, n_tiles, tt, k = slots.shape
    T = math.isqrt(tt)
    M = cand_idx.shape[-1]
    sums = zbuf_backward_tile_plain(slots.reshape(-1, tt, k),
                                    to_tiles(g_zbuf, T), M)
    offs = torch.arange(b, device=cand_idx.device)[:, None, None] * P
    gz = torch.zeros(b * P, dtype=torch.float32, device=g_zbuf.device)
    return gz.index_add_(0, (cand_idx + offs).reshape(-1),
                         sums.reshape(-1)).reshape(b, P)


def zbuf_backward_points_cuda(slots: torch.Tensor, g_zbuf: torch.Tensor,
                              cand_idx: torch.Tensor, P: int,
                              tile_sums: bool = False):
    """Launch the CUDA kernel; same arguments and result as the plain
    version. With `tile_sums`, returns (gz, the (B·n_tiles, M) tile sums)."""
    for t in (slots, g_zbuf, cand_idx):
        if not t.is_cuda or t.device != g_zbuf.device:
            raise ValueError("zbuf_backward_points_cuda takes CUDA tensors on "
                             "one device")
    if (g_zbuf.dtype != torch.float32 or slots.dtype != torch.int32
            or cand_idx.dtype != torch.int64):
        raise TypeError("slots must be int32 (as the fine stage emits them), "
                        "g_zbuf float32 and cand_idx int64")
    b, n_tiles, tt, k = slots.shape
    T = math.isqrt(tt)
    S = g_zbuf.shape[1]
    M = cand_idx.shape[-1]
    if (T * T != tt or S % T != 0 or n_tiles != (S // T) ** 2 or P < 1
            or g_zbuf.shape != (b, S, S, k) or cand_idx.shape[:2] != (b, n_tiles)):
        raise ValueError("slots (B, (S/T)², T², K), g_zbuf (B, S, S, K) and "
                         "cand_idx (B, (S/T)², M) must agree, P >= 1")
    dev = g_zbuf.device
    gz = torch.zeros((b, P), dtype=torch.float32, device=dev)
    sums = (torch.empty((b * n_tiles, M), dtype=torch.float32, device=dev)
            if tile_sums else None)
    sl, g, ci = slots.contiguous(), g_zbuf.contiguous(), cand_idx.contiguous()
    lib = _zbuf_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ZBUF_KERNEL.launch(b * n_tiles)
    err = lib.zbuf_backward_points(sl.data_ptr(), g.data_ptr(), ci.data_ptr(),
                                   b, S, T, k, M, P, gz.data_ptr(),
                                   sums.data_ptr() if tile_sums else None,
                                   stream)
    _build.check_launch(lib, err, "splat_zbuf_bwd")
    return (gz, sums) if tile_sums else gz


def zbuf_backward_points(slots: torch.Tensor, g_zbuf: torch.Tensor,
                         cand_idx: torch.Tensor, P: int) -> torch.Tensor:
    """The (B, P) z gradient from the zbuf cotangent: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if g_zbuf.is_cuda:
        return zbuf_backward_points_cuda(slots, g_zbuf, cand_idx, P)
    if g_zbuf.device.type != "cpu":
        raise ValueError(f"zbuf_backward_points runs on CUDA or CPU, not "
                         f"{g_zbuf.device}")
    return zbuf_backward_points_plain(slots, g_zbuf, cand_idx, P)
