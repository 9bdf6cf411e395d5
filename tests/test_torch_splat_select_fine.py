"""Models of the splat selection and fine-stage kernels' designs, in
PyTorch, held against their plain versions on the CPU.

The kernels (isopoints_torch/csrc/splat_select.cu, splat_fine.cu) cannot
run here. Each model repeats its kernel's arithmetic and schedule:

- `cluster_select_model`: the selection as a cluster of `C` blocks runs it.
  Each block scans a contiguous part of the splats, each of its eight warps
  a contiguous piece of that part (a multiple of 32 long); the strip's
  count, and where it overflows the strip capacity each radix round's
  256-bin histograms and the strict and tie counts, are summed over the
  blocks as the cluster sums them; each warp's first slot in the list is
  the count of splats taken before it, with the threshold ties handed out
  in index order; a warp places its splats 32 at a time by ballots. The
  tile phase runs the same on the list in one block.
- `fine_walk_model`: the fine stage's ranked walk: the ok candidates
  ranked by (depth bits, global id, position), each pixel appending hits in
  that order and stopping, once it has a hit, at the first candidate past
  the depth-merging cut, or at the K-th kept hit; optionally the per-warp
  box cull, with the kernel's conservative test at the warp rectangle's
  corners.

Tolerances: none. Candidate sets and overflow equal the plain selection's,
and every list is in index order; the fine stage's maps, `used` and
`slots` equal the plain version's bit for bit (the model forms dx, dy and q
with the same float32 operations and fused multiply-adds), also on a
permuted candidate list (with `used` and `slots` permuted to match).
"""

import numpy as np
import pytest
import torch

from isopoints_torch.rendering.select import (pixel_ndc, select_candidates_plain,
                                              tile_centers)
from isopoints_torch.rendering.splat import N_ATTRS, rasterize_fine_plain
from isopoints_torch.utils import fma

WARPS = 8      # warps a block in both kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and OpenMP pools that each take every core stall one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The selection: a cluster per strip, a block per group of tiles
# ---------------------------------------------------------------------------

def _depth_keys(z: torch.Tensor) -> torch.Tensor:
    """The kernel's keys: the depth's bits without the sign (z >= 0)."""
    return z.contiguous().view(torch.int32).long() & 0x7FFFFFFF


def _warp_ranges(lo: int, hi: int):
    per = (-(-(hi - lo) // WARPS) + 31) // 32 * 32
    return [(min(hi, lo + w * per), min(hi, lo + w * per + per)) for w in range(WARPS)]


def _radix_select(keys, active, parts, k: int):
    """The k-th smallest active key by four 8-bit rounds, each round's
    histogram the sum of the parts' own; returns (key, rank left among its
    ties)."""
    prefix = mask = 0
    for shift in (24, 16, 8, 0):
        hist = 0
        for lo, hi in parts:
            kp = keys[lo:hi][active[lo:hi]]
            kp = kp[(kp & mask) == prefix]
            hist = hist + torch.bincount((kp >> shift) & 255, minlength=256)
        cum = torch.cumsum(hist, 0)
        b = int(torch.searchsorted(cum, k))
        k -= int(cum[b - 1]) if b else 0
        prefix |= b << shift
        mask |= 255 << shift
    return prefix, k


def _compact(keys, active, parts, cap: int):
    """The taken elements' positions in the list, as the blocks and warps
    place them: (positions (n,) in index order, count of active)."""
    count = int(active.sum())
    v, n_tie = (1 << 32), 0                     # above every key: take all
    if count > cap:
        v, n_tie = _radix_select(keys, active, parts, cap)
    ranges = [r for lo, hi in parts for r in _warp_ranges(lo, hi)]
    n_taken = min(count, cap)
    out = torch.full((n_taken,), -1, dtype=torch.long)
    slot = ties_before = 0
    for lo, hi in ranges:               # the counts' prefix, range by range
        act = active[lo:hi]
        strict = int((act & (keys[lo:hi] < v)).sum())
        tie = int((act & (keys[lo:hi] == v)).sum())
        w_slot, w_ties = slot, ties_before
        for base in range(lo, hi, 32):  # the ballots, 32 at a time
            e = torch.arange(base, min(base + 32, hi))
            ok = active[e]
            is_tie = ok & (keys[e] == v)
            tie_rank = w_ties + torch.cumsum(is_tie.long(), 0) - is_tie.long()
            taken = (ok & (keys[e] < v)) | (is_tie & (tie_rank < n_tie))
            pos = w_slot + torch.cumsum(taken.long(), 0) - taken.long()
            assert bool((pos[taken] < n_taken).all())
            out[pos[taken]] = e[taken]
            w_ties += int(is_tie.sum())
            w_slot += int(taken.sum())
        slot += strict + max(0, min(n_tie - ties_before, tie))
        ties_before += tie
        assert w_slot == slot
    assert slot == n_taken and bool((out >= 0).all())
    return out, count


def cluster_select_model(px, py, z, rx, ry, valid, S: int, T: int, R: int,
                         M: int, C: int = 8):
    """(cand_idx (B, nt², M), cand_ok, overflow (B,)) as the cluster kernel
    computes them; a tile's list in index order."""
    b_n, p = px.shape
    nt = S // T
    r_cap = min(R, p) if R else p
    half = float(T - 1) / S
    cx = tile_centers(S, T)
    chunk = -(-p // C)
    parts = [(min(p, r * chunk), min(p, r * chunk + chunk)) for r in range(C)]
    cidx = torch.zeros((b_n, nt, nt, M), dtype=torch.long)
    cok = torch.zeros((b_n, nt, nt, M), dtype=torch.bool)
    ovf = torch.zeros(b_n, dtype=torch.long)
    for b in range(b_n):
        keys = _depth_keys(z[b])
        for g in range(nt):
            in_strip = valid[b] & (torch.abs(py[b] - cx[g]) <= ry[b] + half)
            lst, count_s = _compact(keys, in_strip, parts, r_cap)
            assert bool((lst[1:] > lst[:-1]).all())          # index order
            l_px, l_rx, l_key = px[b][lst], rx[b][lst], keys[lst]
            for tj in range(nt):
                in_tile = torch.abs(l_px - cx[tj]) <= l_rx + half
                take, count_t = _compact(l_key, in_tile, [(0, len(lst))], M)
                cidx[b, g, tj, :len(take)] = lst[take]
                cok[b, g, tj, :len(take)] = True
                ovf[b] += max(count_t - M, 0)
            ovf[b] += max(count_s - r_cap, 0)
    return cidx.reshape(b_n, nt * nt, M), cok.reshape(b_n, nt * nt, M), ovf


def _splats(rng, P, z_ties=False):
    px = rng.uniform(-1.1, 1.1, P).astype(np.float32)
    py = rng.uniform(-1.1, 1.1, P).astype(np.float32)
    z = rng.uniform(0.5, 3.0, P).astype(np.float32)
    if z_ties:
        z = (np.round(z * 8.0) / 8.0).astype(np.float32)
    rx = rng.uniform(0.01, 0.25, P).astype(np.float32)
    ry = rng.uniform(0.01, 0.25, P).astype(np.float32)
    valid = rng.uniform(size=P) > 0.1
    return [torch.from_numpy(a)[None] for a in (px, py, z, rx, ry, valid)]


def _split_ties(rng, P, C, R, n_ties=20, quota=13):
    """Every splat overlaps every strip; n_ties splats at depth 1.0 around
    the boundary of the first two of C parts, each over every tile, and
    R - quota strictly in front: the strip's threshold is 1.0 and its
    `quota` ties come from both parts."""
    chunk = -(-P // C)
    tie_idx = np.arange(chunk - n_ties // 2, chunk + n_ties // 2)
    rest = np.setdiff1d(np.arange(P), tie_idx)
    front = rng.choice(rest, R - quota, replace=False)
    z = rng.uniform(1.01, 3.0, P).astype(np.float32)
    z[front] = rng.uniform(0.5, 0.99, len(front))
    z[tie_idx] = 1.0
    px = rng.uniform(-1.0, 1.0, P).astype(np.float32)
    py = np.zeros(P, np.float32)
    rx = rng.uniform(0.05, 0.4, P).astype(np.float32)
    ry = np.full(P, 2.0, np.float32)
    px[tie_idx], rx[tie_idx] = 0.0, 2.0
    valid = np.ones(P, bool)
    return [torch.from_numpy(a)[None] for a in (px, py, z, rx, ry, valid)], tie_idx


def _sets(ci, ok):
    return [set(c[o].tolist()) for c, o in zip(ci.reshape(-1, ci.shape[-1]),
                                              ok.reshape(-1, ok.shape[-1]))]


def _assert_model_matches_plain(args, S, T, R, M, C):
    ci, ok, ovf = cluster_select_model(*args, S, T, R, M, C)
    ci_p, ok_p, ovf_p = select_candidates_plain(*args, S, T, R, M)
    assert torch.equal(ovf, ovf_p)
    assert _sets(ci, ok) == _sets(ci_p, ok_p)
    # a tile's list in index order, then the padding (index 0, not ok)
    n_ok = ok.sum(-1, keepdim=True)
    assert torch.equal(ok, torch.arange(M) < n_ok)
    assert bool(((ci[..., 1:] > ci[..., :-1]) | ~ok[..., 1:]).all())
    assert bool((ci[~ok] == 0).all())
    return ci, ok, ovf


@pytest.mark.parametrize("seed,z_ties,S,R,M,C", [(0, False, 64, 2048, 48, 8),
                                                 (1, False, 64, 64, 24, 8),
                                                 (2, True, 64, 48, 16, 8),
                                                 (3, True, 48, 80, 32, 4)])
def test_cluster_selection_model_matches_plain(seed, z_ties, S, R, M, C):
    """Random clouds: no strip overflow, strips past R, and tie-heavy depths
    (z rounded to 1/8) past both capacities; 8 and 4 blocks a cluster."""
    rng = np.random.RandomState(seed)
    args = _splats(rng, 640, z_ties)
    args = args[:5] + [args[5] & (args[2] >= 0)]
    _, _, ovf = _assert_model_matches_plain(args, S, 16, R, M, C)
    assert int(ovf[0]) > 0 or R >= 640


@pytest.mark.parametrize("C", [8, 4])
def test_cluster_selection_model_threshold_ties_in_two_parts(C):
    """A strip past R whose threshold ties fall in two blocks' parts: the
    lower block's ties all go in, the next block's fill the rest, in index
    order."""
    rng = np.random.RandomState(11 + C)
    P, R, M, S, T = 2000, 100, 100, 64, 16
    args, tie_idx = _split_ties(rng, P, C, R)
    ci, ok, ovf = _assert_model_matches_plain(args, S, T, R, M, C)
    # every tile's list holds the first 13 ties, from both parts
    strip = set(ci[0, 0][ok[0, 0]].tolist())
    assert set(tie_idx[:13].tolist()) <= strip
    assert not set(tie_idx[13:].tolist()) & strip
    assert int(ovf[0]) >= (S // T) * (P - R)


# ---------------------------------------------------------------------------
# The fine stage: a depth-ordered walk that stops
# ---------------------------------------------------------------------------

def _order_bits(z: torch.Tensor) -> torch.Tensor:
    """The kernel's depth order key: float bits mapped to an unsigned order
    (+0 for -0), as int64."""
    u = torch.where(z == 0, torch.zeros_like(z), z).contiguous().view(torch.int32).long()
    u = u & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def fine_walk_model(table, cand_idx, cand_ok, S: int, T: int, K: int,
                    depth_merge: float, cull: bool = False):
    """The fine kernel's schedule: rank, then the ordered walk per pixel.
    Returns (idx, zbuf, qvalue, occ, used, slots) as the plain version lays
    them out, and the candidates each warp walked before all its lanes were
    done (B, n_tiles, warps)."""
    b, n_tiles, M = cand_idx.shape
    nt = S // T
    attrs = torch.gather(table, 1, cand_idx.reshape(b, -1, 1).expand(-1, -1, N_ATTRS)
                         ).reshape(b, n_tiles, M, N_ATTRS)
    # rank of each ok entry among the ok ones by (depth, id, position)
    key = _order_bits(attrs[..., 2])
    kj, km = key[..., None, :], key[..., :, None]
    gj, gm = cand_idx[..., None, :], cand_idx[..., :, None]
    pos = torch.arange(M)
    before = (kj < km) | ((kj == km) & ((gj < gm) | ((gj == gm) & (pos[None, :] < pos[:, None]))))
    rank = (before & cand_ok[..., None, :]).sum(-1)
    n_ok = cand_ok.sum(-1)                                            # (B, t)
    tgt = torch.where(cand_ok, rank, M)                               # not-ok: a dump slot
    s_att = torch.zeros((b, n_tiles, M + 1, N_ATTRS)).scatter(
        2, tgt[..., None].expand(-1, -1, -1, N_ATTRS), attrs)[:, :, :M]
    s_gid = torch.zeros((b, n_tiles, M + 1), dtype=torch.long).scatter(2, tgt, cand_idx)[..., :M]
    s_slot = torch.zeros((b, n_tiles, M + 1), dtype=torch.long).scatter(
        2, tgt, pos.expand(b, n_tiles, M))[..., :M]

    lanes = -(-T * T // 32) * 32
    lin = torch.arange(lanes)
    active = lin < T * T
    pl = torch.clamp(lin, max=T * T - 1)
    tiles = torch.arange(n_tiles)
    rows = (tiles // nt)[:, None] * T + (pl // T)[None]                 # (t, lanes)
    cols = (tiles % nt)[:, None] * T + (pl % T)[None]
    xf, yf = pixel_ndc(cols, S), pixel_ndc(rows, S)
    warps = lanes // 32
    wsh = (n_tiles, warps, 32)
    # the warp rectangle's corners (ndc falls as the index rises)
    x_hi = pixel_ndc(cols.reshape(wsh).amin(-1), S)[None]
    x_lo = pixel_ndc(cols.reshape(wsh).amax(-1), S)[None]
    y_hi = pixel_ndc(rows.reshape(wsh).amin(-1), S)[None]
    y_lo = pixel_ndc(rows.reshape(wsh).amax(-1), S)[None]

    shape = (b, n_tiles, lanes)
    nh = torch.zeros(shape, dtype=torch.long)
    z0 = torch.zeros(shape)
    occ = torch.zeros(shape, dtype=torch.bool)
    done = ~active.expand(shape).clone()
    out = {k: torch.full(shape + (K + 1,), -1, dtype=d) for k, d in
           (("idx", torch.long), ("slot", torch.long))}
    out.update({k: torch.full(shape + (K + 1,), -1.0) for k in ("z", "q")})
    used = torch.zeros((b, n_tiles, M + 1), dtype=torch.bool)
    walked = torch.zeros((b, n_tiles, warps), dtype=torch.long)
    for r in range(M):
        a = s_att[:, :, r]                                            # (B, t, 9)
        c = lambda j: a[..., j][..., None]
        live = (r < n_ok)[..., None]
        if cull:
            near = ((x_hi - c(0) >= -c(6)) & (x_lo - c(0) <= c(6))
                    & (y_hi - c(1) >= -c(7)) & (y_lo - c(1) <= c(7)))   # (B, t, warps)
            near = near[..., None].expand(-1, -1, -1, 32).reshape(shape)
        else:
            near = torch.ones(shape, dtype=torch.bool)
        walking = ~done.reshape(b, n_tiles, warps, 32).all(-1)          # the __all_sync
        walked += walking & live
        dx = xf[None] - c(0)
        dy = yf[None] - c(1)
        q = fma(c(5) * dy, dy, fma(c(3) * dx, dx, c(4) * dx * dy))
        z = c(2).expand(shape)
        visit = live & near & ~done
        # past the cut with a hit in hand: no later candidate can be kept
        stop = visit & occ & ~((z - z0) <= depth_merge)
        hit = ((torch.abs(dx) <= c(6)) & (torch.abs(dy) <= c(7)) & (q <= c(8))
               & visit & ~stop)
        z0 = torch.where(hit & ~occ, z, z0)
        occ = occ | hit
        keep = hit & ((z - z0) <= depth_merge)
        at = torch.where(keep, nh, K)[..., None]
        for name, v in (("idx", s_gid[:, :, r]), ("slot", s_slot[:, :, r]),
                        ("z", z[..., 0]), ("q", q)):
            val = v[..., None].expand(shape) if v.dim() == 2 else v
            out[name] = out[name].scatter(-1, at, val[..., None].to(out[name].dtype))
        used = used.scatter(-1, torch.where(keep, s_slot[:, :, r, None], M), True)
        nh = nh + keep.long()
        done = done | stop | (hit & ~keep) | (nh == K)
    tt = T * T
    cut = lambda x: x[:, :, :tt, :K]
    return (cut(out["idx"]), cut(out["z"]), cut(out["q"]), occ[:, :, :tt].float(),
            used[..., :M], cut(out["slot"]).to(torch.int32)), walked


def _table(rng, px, py, z, rx, ry, cutoff=1.0):
    ell = torch.from_numpy(rng.uniform(5.0, 40.0, px.shape + (3,)).astype(np.float32))
    ell[..., 1] = torch.from_numpy(rng.uniform(-3.0, 3.0, px.shape).astype(np.float32))
    return torch.stack([px, py, z, ell[..., 0], ell[..., 1], ell[..., 2], rx, ry,
                        torch.full_like(px, cutoff)], -1)


def _assert_walk_matches_plain(table, ci, ok, S, T, K, dm, cull):
    got, walked = fine_walk_model(table, ci, ok, S, T, K, dm, cull)
    ref = rasterize_fine_plain(table, ci, ok, S, T, K, dm)
    for name, a, b in zip(("idx", "zbuf", "qvalue", "occ", "used", "slots"), got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    return ref, walked


def _cut_cloud(rng, S, dm):
    """Depth triples at the merging cut: each base depth z0, fl(z0 + dm) and
    the float above it, on splats that cover a few shared pixels."""
    base = rng.uniform(0.3, 2.5, 40).astype(np.float32)
    at = (base + np.float32(dm)).astype(np.float32)
    above = np.nextafter(at, np.float32(np.inf))
    z = np.concatenate([base, at, above]).astype(np.float32)
    n = len(z)
    c = rng.uniform(-0.8, 0.8, (40, 2)).astype(np.float32)
    c = np.concatenate([c, c, c]) + rng.uniform(-0.02, 0.02, (n, 2)).astype(np.float32)
    r = rng.uniform(0.05, 0.15, (n, 2)).astype(np.float32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))[None]
    return t(c[:, 0]), t(c[:, 1]), t(z), t(r[:, 0]), t(r[:, 1])


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("case", ["random", "ties", "cut", "sparse", "negative cut"])
def test_fine_walk_model_matches_plain(case, cull):
    """The ranked walk with the early exit (and the per-warp cull) equals
    the plain version bit for bit: random clouds, tie-heavy depths (z
    rounded to 1/8), hits exactly at the merging cut (z = z0 + depth_merge
    as a float, and the float above), tiles with fewer than K hits, and a
    cut below 0 (no hit kept, occupancy set)."""
    rng = np.random.RandomState(["random", "ties", "cut", "sparse",
                                 "negative cut"].index(case))
    S, T, K, M, dm = 64, 16, 5, 48, 0.05
    if case == "cut":
        px, py, z, rx, ry = _cut_cloud(rng, S, dm)
        valid = torch.ones_like(px, dtype=torch.bool)
    else:
        px, py, z, rx, ry, valid = _splats(rng, 60 if case == "sparse" else 1200,
                                           z_ties=case == "ties")
    if case == "random":
        dm = 0.5            # deep enough that many pixels keep K
    if case == "negative cut":
        dm = -1e-3
    ci, ok, _ = select_candidates_plain(px, py, z, rx, ry, valid, S, T, 0, M)
    table = _table(rng, px, py, z, rx, ry)
    ref, walked = _assert_walk_matches_plain(table, ci, ok, S, T, K, dm, cull)
    n_hits = (ref.idx >= 0).sum(-1)
    assert int(ref.occ.sum()) > 50
    if case == "sparse":
        assert bool(((n_hits > 0) & (n_hits < K)).any())
    if case == "random":
        assert int((n_hits == K).sum()) > 50
    if case in ("random", "ties"):
        # pixels stop: the warps walk fewer candidates than the tiles hold
        assert int(walked.sum()) < int(ok.sum(-1, keepdim=True).expand_as(walked).sum())
    if case == "cut":
        # hits kept right at the cut
        gap = ref.zbuf[..., 1:] - ref.zbuf[..., :1]
        assert bool((gap[ref.idx[..., 1:] >= 0] > dm - 1e-6).any())
    if case == "negative cut":
        assert int((ref.idx >= 0).sum()) == 0 and int(ref.occ.sum()) > 0


@pytest.mark.parametrize("cull", [False, True])
def test_fine_walk_model_on_permuted_list(cull):
    """A tile's candidate list in another order: the same maps, with `used`
    and `slots` permuted to match."""
    rng = np.random.RandomState(5)
    S, T, K, M = 64, 16, 5, 48
    px, py, z, rx, ry, valid = _splats(rng, 400, z_ties=True)
    ci, ok, _ = select_candidates_plain(px, py, z, rx, ry, valid, S, T, 0, M)
    table = _table(rng, px, py, z, rx, ry)
    perm = torch.from_numpy(np.stack([rng.permutation(M) for _ in range(ci.shape[1])]))[None]
    inv = torch.argsort(perm, dim=-1)
    shuf = lambda x: torch.gather(x, 2, perm)
    ref = rasterize_fine_plain(table, ci, ok, S, T, K, 0.05)
    got, _ = fine_walk_model(table, shuf(ci), shuf(ok), S, T, K, 0.05, cull)
    idx, zbuf, qv, occ, used, slots = got
    for name, a, b in (("idx", idx, ref.idx), ("zbuf", zbuf, ref.zbuf),
                       ("qvalue", qv, ref.qvalue), ("occ", occ, ref.occ)):
        assert torch.equal(a, b), name
    assert torch.equal(used, shuf(ref.used))
    moved = torch.gather(inv, 2, ref.slots.long().clamp(min=0).reshape(1, ci.shape[1], -1)
                         ).reshape(ref.slots.shape)
    assert torch.equal(slots, torch.where(ref.slots >= 0, moved, -1).to(torch.int32))
