"""Exact masked k-nearest neighbours: a hand-written CUDA kernel and its
plain version (port of isopoints_tpu/ops/neighbors.py `knn_points` and
`knn_gather`), and the fixed-radius searches built on them
(`radius_search`, `grid_radius_search`).

The kernel (csrc/knn.cu) replaces `_knn_kernel` of
isopoints_tpu/ops/pallas_knn.py (:83, wrapper `knn_points_pallas` :286):
a group of 16 lanes (32 for 16 < k <= 32) serves one query, each lane
scanning a strided share of the points from shared memory, and the group
keeps one sorted list of the k best by (distance, index), an entry a lane,
whose k-th entry
bounds which points are candidates; a candidate is inserted by a ballot
and a shuffle. From `SORT_MIN` points on, the wrapper first orders the
points (and the queries, when they are the points) by Morton code, on the
card (`knn_morton_codes`, then `torch.sort`), and the kernel skips every
64-point block of that order whose bounding box cannot hold a point
nearer than the bound, and every tile no query of a block needs: the TPU
kernel's pruning. Below it the sort's launches cost more than the pruning
saves. Bound on an H100: the f32 CUDA-core rate over the N·P distance
evaluations.

`knn_points(..., method="auto")` launches the kernel for CUDA tensors
(k <= 32, the most any op of the JAX package asks for: the RIMLS losses'
knn_k; larger k on CUDA raises) and runs the plain version
`knn_points_dense` for CPU tensors. `method="dense"` asks
for the plain version on any device. The plain version is the JAX
package's dense path (neighbors.py:90-149): |q|² + |p|² − 2·q·p clamped at
0, masked points pushed out by 1e10, then k masked-min sweeps whose
first-occurrence argmin breaks ties by the lower index. The squared norms
and the dot product are formed as fused multiply-add chains over x, y, z
(`dot3`), which is how XLA rounds them on the CPU; the kernel does the same
with __fmaf_rn, so the distances agree bit for bit.
"""

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from isopoints_torch.ops import _build
from isopoints_torch.utils import fma

KERNEL = _build.LaunchCount("knn")
MAX_K = 32
SORT_MIN = 16384   # points from which the kernel runs on the Morton order
_BIG = 1e10
_BLOCK = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    lib.knn_forward.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P, _P, _P]
    lib.knn_forward.restype = _I
    lib.knn_morton_codes.argtypes = [_P, _P, _I, _I, _P, _P]
    lib.knn_morton_codes.restype = _I
    return lib


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b over the last axis (size 3) as fma(a_z, b_z, fma(a_y, b_y,
    a_x·b_x)); a and b broadcast."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


class KNNResult(NamedTuple):
    dists: torch.Tensor  # (B, N, K) squared distances, ascending; 1e10 if invalid
    idx: torch.Tensor    # (B, N, K) int64 indices into points; -1 if invalid
    mask: torch.Tensor   # (B, N, K) validity


def _finish(dists: torch.Tensor, idx: torch.Tensor, query_mask: torch.Tensor,
            k: int) -> KNNResult:
    """Validity, -1 / 1e10 fill and padding to k columns (neighbors.py:141-149)."""
    valid = (dists < _BIG * 0.5) & query_mask[..., None]
    if dists.shape[-1] < k:
        padw = k - dists.shape[-1]
        dists = torch.nn.functional.pad(dists, (0, padw), value=_BIG)
        idx = torch.nn.functional.pad(idx, (0, padw), value=-1)
        valid = torch.nn.functional.pad(valid, (0, padw), value=False)
    idx = torch.where(valid, idx, -1)
    dists = torch.where(valid, dists, torch.full_like(dists, _BIG))
    return KNNResult(dists=dists, idx=idx, mask=valid)


def knn_points_dense(query: torch.Tensor, points: torch.Tensor,
                     query_mask: torch.Tensor, points_mask: torch.Tensor,
                     k: int, exclude_self: bool = False) -> KNNResult:
    """Plain version: blocked dense distances + k masked-min sweeps."""
    b, n, _ = query.shape
    p = points.shape[1]
    points = torch.where(points_mask[..., None], points, 0.0)
    query = torch.where(query_mask[..., None], query, 0.0)
    kk = min(k, p)
    pts_sq = dot3(points, points)
    invalid = torch.where(points_mask, 0.0, _BIG)
    d_out, i_out = [], []
    cols = torch.arange(p, device=points.device)
    for lo in range(0, n, _BLOCK):
        qb = query[:, lo:lo + _BLOCK]
        d = ((dot3(qb, qb)[..., None] + pts_sq[:, None, :])
             - 2.0 * dot3(qb[:, :, None, :], points[:, None, :, :]))
        d = torch.clamp(d, min=0.0) + invalid[:, None, :]
        if exclude_self:
            qi = torch.arange(lo, lo + qb.shape[1], device=points.device)
            d = torch.where(qi[:, None] == cols[None, :], _BIG, d)
        vals, idxs = [], []
        for _ in range(kk):
            i = torch.argmin(d, dim=-1)
            vals.append(torch.gather(d, -1, i[..., None])[..., 0])
            idxs.append(i)
            d = d.scatter(-1, i[..., None], float("inf"))
        d_out.append(torch.stack(vals, -1))
        i_out.append(torch.stack(idxs, -1))
    if n == 0:
        empty = query.new_zeros((b, 0, kk))
        return _finish(empty, empty.long(), query_mask, k)
    return _finish(torch.cat(d_out, 1), torch.cat(i_out, 1), query_mask, k)


def knn_points_cuda(query: torch.Tensor, points: torch.Tensor,
                    query_mask: torch.Tensor, points_mask: torch.Tensor,
                    k: int, exclude_self: bool = False) -> KNNResult:
    """Launch the CUDA kernel (contiguous float32 CUDA tensors, k <= 32)."""
    if k > MAX_K:
        raise ValueError(f"the CUDA kNN kernel takes k <= {MAX_K}, got k={k}")
    for t in (query, points, query_mask, points_mask):
        if not t.is_cuda or t.device != query.device:
            raise ValueError("knn_points_cuda takes CUDA tensors on one device")
    if query.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError("knn_points_cuda takes float32 positions")
    b, n, _ = query.shape
    p = points.shape[1]
    if exclude_self and n != p:
        raise ValueError("exclude_self needs query IS points (n == p)")
    if query_mask.dtype != torch.bool or points_mask.dtype != torch.bool:
        raise TypeError("knn_points_cuda takes bool masks")
    q = query.contiguous()
    pts = points.contiguous()
    qm = query_mask.contiguous()   # bool: one byte, 0 or 1, as the kernel reads it
    pm = points_mask.contiguous()
    dists = torch.empty((b, n, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((b, n, k), dtype=torch.int64, device=q.device)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    order = box = q_order = None
    if p >= SORT_MIN:
        code = torch.empty((b, p), dtype=torch.int32, device=q.device)
        err = lib.knn_morton_codes(pts.data_ptr(), pm.data_ptr(), b, p,
                                   code.data_ptr(), stream)
        _build.check_launch(lib, err, "knn (Morton codes)")
        order = torch.sort(code, dim=1).indices
        box = torch.empty((b, -(-p // 64), 8), dtype=torch.float32, device=q.device)
        if (query.data_ptr() == points.data_ptr() and n == p
                and query_mask.data_ptr() == points_mask.data_ptr()):
            q_order = order   # queries are the points: take them in the same order
    ptr = lambda t: None if t is None else t.data_ptr()
    KERNEL.launches += 1
    err = lib.knn_forward(q.data_ptr(), qm.data_ptr(), pts.data_ptr(),
                          pm.data_ptr(), ptr(q_order), ptr(order), ptr(box), b,
                          n, p, k, int(exclude_self), dists.data_ptr(),
                          idx.data_ptr(), stream)
    _build.check_launch(lib, err, "knn")
    # the kernel leaves -1 and 1e10 in every empty entry and on every
    # column of a masked query, as `_finish` does for the plain version
    return KNNResult(dists=dists, idx=idx, mask=idx >= 0)


def knn_points(query: torch.Tensor, points: torch.Tensor,
               query_mask: Optional[torch.Tensor] = None,
               points_mask: Optional[torch.Tensor] = None, k: int = 8,
               exclude_self: bool = False, method: str = "auto") -> KNNResult:
    """Masked kNN (neighbors.py:46-149). query (B, N, 3), points (B, P, 3),
    masks (B, N) / (B, P) bool. `exclude_self` drops index i for query i
    (query IS points). `method`: 'auto' (kernel on CUDA, plain on CPU) or
    'dense' (the plain version anywhere)."""
    b, n, _ = query.shape
    p = points.shape[1]
    if points_mask is None:
        points_mask = torch.ones((b, p), dtype=torch.bool, device=points.device)
    if query_mask is None:
        query_mask = torch.ones((b, n), dtype=torch.bool, device=query.device)
    if method == "dense":
        return knn_points_dense(query, points, query_mask, points_mask, k,
                                exclude_self)
    if method != "auto":
        raise ValueError(f"unknown kNN method {method!r}")
    if query.is_cuda:
        return knn_points_cuda(query, points, query_mask, points_mask, k,
                               exclude_self)
    if query.device.type != "cpu":
        raise ValueError(f"knn_points runs on CUDA or CPU, not {query.device}")
    return knn_points_dense(query, points, query_mask, points_mask, k,
                            exclude_self)


def knn_gather(x: torch.Tensor, idx: torch.Tensor, fill: float = 0.0
               ) -> torch.Tensor:
    """x (B, P, C), idx (B, N, K) with -1 for invalid -> (B, N, K, C),
    `fill` where idx < 0 (neighbors.py:324-334)."""
    b, n, k = idx.shape
    safe = torch.clamp(idx, min=0).reshape(b, n * k, 1).expand(-1, -1, x.shape[-1])
    out = torch.gather(x, 1, safe).reshape(b, n, k, x.shape[-1])
    return torch.where((idx < 0)[..., None], torch.full_like(out, fill), out)


def radius_search(query: torch.Tensor, points: torch.Tensor, radius: float,
                  query_mask: Optional[torch.Tensor] = None,
                  points_mask: Optional[torch.Tensor] = None, k: int = 8,
                  exclude_self: bool = False, method: str = "auto",
                  max_per_cell: int = 64,
                  block_size: Optional[int] = None) -> KNNResult:
    """The k nearest points within `radius` (neighbors.py:152-195); misses
    are idx -1 / dist 1e10. `method`: 'dense' takes `knn_points` (the kNN
    kernel on CUDA tensors) and cuts by the radius; 'grid' is
    `grid_radius_search`; 'auto' takes the grid above `GRID_MIN` database
    points, as the JAX package does."""
    if method == "auto":
        method = "grid" if points.shape[1] > GRID_MIN else "dense"
    if method == "grid":
        return grid_radius_search(query, points, radius, query_mask,
                                  points_mask, k=k, max_per_cell=max_per_cell,
                                  block_size=block_size,
                                  exclude_self=exclude_self)
    if method != "dense":
        raise ValueError(f"unknown radius search method {method!r}")
    res = knn_points(query, points, query_mask, points_mask, k=k,
                     exclude_self=exclude_self)
    # the radius squared in double, then rounded to float32 (a weak-typed
    # Python float against float32 distances in the JAX package)
    r2 = torch.tensor(radius * radius, dtype=res.dists.dtype, device=res.dists.device)
    valid = res.mask & (res.dists <= r2)
    return KNNResult(dists=torch.where(valid, res.dists, _BIG),
                     idx=torch.where(valid, res.idx, -1), mask=valid)


# 10 bits a cell coordinate (neighbors.py:200-203): up to 1024 cells an axis
_GRID_BITS = 10
_GRID_MAX = (1 << _GRID_BITS) - 1
_CELL_SENTINEL = 1 << 30
GRID_MIN = 32768   # 'auto' takes the grid above this many database points


def _grid_offsets(device) -> torch.Tensor:
    """The 27 neighbour cell offsets in `meshgrid(indexing="ij")` order."""
    r = torch.arange(-1, 2, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(27, 3)


def _cell_id(ci: torch.Tensor) -> torch.Tensor:
    ci = torch.clamp(ci, 0, _GRID_MAX)
    return ((ci[..., 0] << (2 * _GRID_BITS)) + (ci[..., 1] << _GRID_BITS)
            + ci[..., 2])


@torch.no_grad()
def grid_radius_search(query: torch.Tensor, points: torch.Tensor,
                       radius: float,
                       query_mask: Optional[torch.Tensor] = None,
                       points_mask: Optional[torch.Tensor] = None,
                       k: int = 8, max_per_cell: int = 64,
                       block_size: Optional[int] = None,
                       exclude_self: bool = False) -> KNNResult:
    """Grid-bucketed fixed-radius k-nearest search (neighbors.py:207-321),
    plain PyTorch on either device, the same index sets as the JAX package.

    Cells of edge `radius` from the minimum corner of the valid points, a
    cell id of 10 bits an axis (clamped); masked points take a sentinel id.
    The points are sorted by cell id (stable), and each query takes
    `max_per_cell` slots from each of its 27 neighbouring cells (two binary
    searches a cell): candidates past `max_per_cell` in a cell are dropped,
    as in the JAX package. The k nearest candidates within the radius, equal
    distances in candidate order (as `lax.top_k` orders them), padded to k
    with −1 / 1e10. Queries go in blocks of `block_size` (by default 8192 on CUDA and
    1024 on the CPU); the block size does not change the result."""
    b, n, _ = query.shape
    p = points.shape[1]
    dev = points.device
    if points_mask is None:
        points_mask = torch.ones((b, p), dtype=torch.bool, device=dev)
    if query_mask is None:
        query_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    if block_size is None:
        block_size = 8192 if points.is_cuda else 1024
    points = torch.where(points_mask[..., None], points, 0.0)
    query = torch.where(query_mask[..., None], query, 0.0)
    r = torch.tensor(radius, dtype=points.dtype, device=dev)
    r2 = r * r
    cap = min(max_per_cell, p)
    if 27 * cap > 1 << 13:
        raise ValueError(f"grid_radius_search takes max_per_cell <= "
                         f"{(1 << 13) // 27}, got {max_per_cell}")
    kk = min(k, 27 * cap)
    offs = _grid_offsets(dev)
    slots = torch.arange(cap, device=dev)
    dists = torch.empty((b, n, kk), dtype=points.dtype, device=dev)
    idx = torch.empty((b, n, kk), dtype=torch.long, device=dev)
    for bi in range(b):
        pts, pmask, q = points[bi], points_mask[bi], query[bi]
        origin = torch.where(
            pmask.any(), torch.amin(torch.where(pmask[:, None], pts, _BIG), dim=0),
            0.0)

        def cell_coords(x):
            # clamped before the cast: every coordinate past the grid's
            # range gives the same (out of range) cells
            c = torch.floor((x - origin) / r)
            return torch.clamp(c, -(1 << 20), 1 << 20).long()

        cid = torch.where(pmask, _cell_id(cell_coords(pts)), _CELL_SENTINEL)
        sorted_id, order = torch.sort(cid, stable=True)
        sorted_pts = pts[order]
        if exclude_self:   # each point's slot in the sorted order
            rank = torch.empty_like(order)
            rank[order] = torch.arange(p, device=dev)
        for lo in range(0, n, block_size):
            qb = q[lo:lo + block_size]
            nci = cell_coords(qb)[:, None, :] + offs[None]          # (bs, 27, 3)
            nok = torch.all((nci >= 0) & (nci <= _GRID_MAX), dim=-1)
            nid = _cell_id(nci)
            start = torch.searchsorted(sorted_id, nid)
            end = torch.searchsorted(sorted_id, nid, right=True)
            slot = start[..., None] + slots                           # (bs, 27, C)
            ok = (slot < end[..., None]) & nok[..., None]
            slot = torch.clamp(slot, max=p - 1)
            diff = qb[:, None, None, :] - sorted_pts[slot]
            d2 = dot3(diff, diff)   # an fma chain, as XLA's CPU build rounds it
            ok = ok & (d2 <= r2)
            if exclude_self:
                ok = ok & (slot != rank[lo:lo + qb.shape[0], None, None])
            d2 = torch.where(ok, d2, _BIG).reshape(qb.shape[0], -1)
            # the k smallest in (distance, candidate position) order, as one
            # key: a non-negative float's bits order as its value
            key = (d2.view(torch.int32).long() << 13) + torch.arange(
                d2.shape[1], device=dev)
            sel = torch.topk(key, kk, dim=1, largest=False).indices
            dists[bi, lo:lo + qb.shape[0]] = torch.gather(d2, 1, sel)
            idx[bi, lo:lo + qb.shape[0]] = order[torch.gather(
                slot.reshape(qb.shape[0], -1), 1, sel)]
    return _finish(dists, idx, query_mask, k)
