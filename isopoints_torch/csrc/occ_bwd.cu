// DSS occupancy backward: the xy gradient of every point of B clouds from
// the occupancy map's cotangent. For a renderable point, the sum over the
// pixels of its W x W patch with grad != 0 and dist^2 <= search_r2 of
// (pixel - point) / dist^2 * grad, leaving out pixels with grad > 0
// outside the point's own (unscaled) splat bbox; zero for the others.
//
// Replaces `occ_backward_pallas_one` (isopoints_tpu/rendering/
// pallas_occ_bwd.py:41, pallas_call :145). Same contract as the plain
// `occ_backward_plain` (rendering/occ_bwd.py), the port of the XLA
// formulation `_occ_backward_one` (isopoints_tpu/rendering/rasterizer.py
// :481-570): the same renderable set, the same search radius bit for bit
// (the median of the renderable radii of both axes, NaN left out, the mean
// of the two middle ones for an even count, nan_to_num, times
// `radii_backward_scaler`, clamped so the patch covers it, squared: the
// float32 operations of `backward_window`, in its order), the same W x W
// patch placed and clipped as :529-532 place it, the same gates, dist^2 as
// dx * dx + dy * dy rounded after each operation (no fused multiply-add)
// and correctly rounded divisions. The TPU kernel's 8-aligned row bands
// and 64-column strips are layout rules of its compiler and have no
// counterpart here.
//
// Bound on an H100: the larger of ~29 bytes a point and 4 a pixel, and
// ~15 FLOP per term of the sums (dx, dist^2, four compares, the max, two
// divisions, two products, two sums) with a compare per other nonzero
// pixel of a point's window (`occ_work` in rendering/occ_bwd.py counts
// them on the inputs); at the shapes below, the bytes.
//
// Design: one C call, two launches on the caller's stream, nothing
// allocated (the wrapper passes the output and one scratch buffer).
//  - The window kernel: a thread-block cluster of kWinCluster blocks a
//    cloud, each block a contiguous part of its points. It writes zeros to
//    the rows of the points that are not renderable, the order-preserving
//    keys of the renderable radii (NaN left out, -0 as +0) and each
//    renderable point's cell (its patch origin divided by the cell side);
//    the blocks sum their counts and 256-bin histograms through
//    distributed shared memory and select the two middle keys by radix
//    selection (no sort): two 8-bit rounds over the cluster, then every
//    key whose top 16 bits can still be a middle one goes to a list that
//    block 0 alone finishes with two more rounds (no cluster barrier
//    there). The blocks place the renderable ids in a list bucketed by
//    cell (a cell's offset plus the lower ranks' counts there; inside a
//    block's share of a cell, in the order of shared atomics, which
//    changes no sum), cut into chunks of at most kChunk points of one
//    cell. Block 0 writes the search radius, the cells' offsets and the
//    chunks.
//  - The walk kernel: a block per chunk (the grid, fixed at launch with no
//    host read, has a block for the most chunks P points can make; the
//    blocks past the count exit). The block stages the halo of its cell's
//    patches, (cell + W - 1)^2 floats of the cotangent, in shared memory
//    with two flags a row: any nonzero, any nonzero that is not positive.
//    Chunks keep the blocks even where the points crowd a cell (a
//    silhouette seen edge-on). Each warp takes a point: a lane two columns
//    of each pair of 32-column chunks, and the rows by ballot: within the
//    window (fl(dy^2) <= search_r2, since fl(fl(dx^2) + fl(dy^2)) >=
//    fl(dy^2) no term of another row counts), holding a nonzero
//    cotangent, and, outside the splat's y-extent, one the
//    positive-gradient gate lets through (a negative or NaN cotangent).
//    So a cotangent that is positive where it is nonzero (the splat
//    frame's Σ occupancy) walks only the rows of each splat's box. Each
//    lane sums its pixels in a fixed order and the warp reduces with a
//    fixed shuffle tree: no atomics in the sums, repeatable bit for bit.
//    Where the halo does not fit in shared memory (very wide patches) the
//    walk reads the cotangent from device memory and visits every row of
//    the window.
//
// What bounds it, measured (`python -m isopoints_torch.kernel_variants
// occ`, which builds copies of this source with one choice replaced; NVIDIA
// H100 80GB HBM3, 700 W; both kernels alone, the splat frame's 24,576
// points at 512 px with its all-ones cotangent / the point model step's 2
// x 5000 points at 256 px with its signed cotangent): 0.0503 / 0.0478 ms
// against a bound of 0.00053 / 0.00024 ms (bytes; 365,768 / 660,495 terms),
// ~95x / ~200x. Fixed costs hold it: the two launches with nothing to do
// take 0.005 ms; the window kernel 0.022 / 0.015, most of it the radix
// rounds' barriers (0.0129 / 0.0089 without rounds 2-4), since one cloud
// runs on 8 SMs; the walk the rest, its halo phase (chunk lookup, loads,
// flags) ~0.012 / ~0.008 and its points ~0.013 / ~0.022, the latter held
// by the instruction count of the correctly rounded divisions of the
// pixels that count. The choices, each against the copy without it: the
// halo (no halo: 0.0814 / 0.0627), the row choice (none: 0.0818 /
// 0.0568), chunks of 16 (a block a cell: 0.0669 / 0.1634; chunks of 8 or
// 32 trade one shape for the other), 16 warps a block (8: 0.0515 /
// 0.0591), a cluster of 8 (1: 0.1036 / 0.0588; 16: 0.0484 / 0.0496),
// cells of 32 px (16: 0.0501 / 0.0520; 8: 0.0679 / 0.0600). Cutting the
// columns to the window changed nothing (0.0507 / 0.0474) and was left
// out; the earlier walk (a warp per point over all P warps, the cotangent
// from device memory) takes 0.0912 / 0.0683.
//
// Plain C interface for ctypes; returns the first launch error, or
// cudaGetLastError() after the launches.

#include <cooperative_groups.h>

#include <cfloat>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWinCluster = 8;  // window kernel: blocks a cloud
constexpr int kWinThreads = 1024;
constexpr int kCell = 32;        // cell side in pixels of patch origin (doubled past kMaxCells)
constexpr int kMaxCells = 8192;  // cells a cloud at most: the scratch's room for offsets
constexpr int kWarps = 16;       // walk kernel: warps a block
constexpr int kChunk = 16;       // walk kernel: points a block at most (a cell's chunk)
constexpr unsigned kNoKey = 0u;  // below the key of every number, -inf included

// The geometry of one launch.
struct Layout {
  int P, S, W;
  int cs, nca, ncell;  // cell side, cells an axis, cells a cloud
  int hs;              // halo side: cs + W - 1, at most S
  long long per;       // scratch ints a cloud: 5 + 7P + 3 kMaxCells
  float inv_s;
};

// One cloud's part of the scratch buffer.
struct Scratch {
  int* head;       // search_r2 (float bits), renderable points, chunks, candidates
  int* ids;        // (P) the renderable ids, bucketed by cell
  unsigned* keys;  // (2P) the radii's keys, kNoKey where left out
  int* off;        // (ncell + 1) each cell's first slot in ids
  int* chunks;     // (P + kMaxCells, 2) each chunk's cell and first slot
  unsigned* cand;  // (2P) the keys that can still be a middle one after two rounds
};

__device__ __forceinline__ Scratch cloud_scratch(int* scratch, const Layout& L, int b) {
  Scratch c;
  c.head = scratch + (size_t)b * L.per;
  c.ids = c.head + 4;
  c.keys = reinterpret_cast<unsigned*>(c.ids + L.P);
  c.off = reinterpret_cast<int*>(c.keys + 2 * (size_t)L.P);
  c.chunks = c.off + kMaxCells + 1;
  c.cand = reinterpret_cast<unsigned*>(c.chunks + 2 * ((size_t)L.P + kMaxCells));
  return c;
}

// Unsigned keys that order as the floats do (not NaN); -0 maps to +0.
__device__ __forceinline__ unsigned order_key(float r) {
  const unsigned u = r == 0.f ? 0u : __float_as_uint(r);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// First patch row/column: the point's pixel (S (1 - ndc) - 1) / 2, rounded
// half to even, minus W/2, clipped to the image.
__device__ __forceinline__ int patch_origin(float ndc, int S, int W) {
  const float f = __fmul_rn(__fsub_rn(__fmul_rn((float)S, __fsub_rn(1.f, ndc)), 1.f), 0.5f);
  return min(max((int)rintf(f) - W / 2, 0), S - W);
}

// visible & z >= 0 & |x| <= 1 & |y| <= 1 (NaN compares false), with x, y.
__device__ __forceinline__ bool renderable(const float* pts, const unsigned char* vis, size_t q,
                                           float& x, float& y) {
  x = pts[3 * q];
  y = pts[3 * q + 1];
  const float z = pts[3 * q + 2];
  return vis[q] != 0 && z >= 0.f && fabsf(x) <= 1.f && fabsf(y) <= 1.f;
}

__device__ __forceinline__ int cell_of(float x, float y, const Layout& L) {
  return (patch_origin(y, L.S, L.W) / L.cs) * L.nca + patch_origin(x, L.S, L.W) / L.cs;
}

// hist[bin] += 1 for each lane with `on`, one shared atomic per distinct
// bin of the warp. The whole warp calls it.
__device__ __forceinline__ void hist_add(int* hist, unsigned bin, bool on) {
  const unsigned peers = __match_any_sync(kFull, on ? bin : 256u);
  if (on && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
}

// In-place exclusive scan of a[0, n) by the whole block; returns the
// total. `tmp`: 33 ints.
__device__ int block_exclusive_scan(int* a, int n, int* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  const int incl = common::warp_inclusive_scan(s);
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nw ? tmp[lane] : 0;
    const int wi = common::warp_inclusive_scan(w);
    __syncwarp();
    tmp[lane] = wi - w;
    if (lane == 31) tmp[32] = wi;
  }
  __syncthreads();
  int run = tmp[warp] + incl - s;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = tmp[32];
  __syncthreads();
  return total;
}

struct WinShared {
  int first[256];       // the first round's histogram (top bytes, lo's and hi's)
  int second[2][256];   // the second round's [lo, hi]
  int sum[2][256];      // the cluster's histograms of a round; block 0's own after
  int count[2];         // this block's keys and renderable points
  int total[2];         // the cloud's
  int bc[2][2];         // radix_pick's results for lo and hi
  int scan[33];
};

__global__ void __launch_bounds__(kWinThreads)
    window_kernel(const float* __restrict__ pts, const float* __restrict__ radii,
                  const unsigned char* __restrict__ vis, Layout L, float scaler, float cap,
                  int clamp, float* __restrict__ out, int* __restrict__ scratch) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ WinShared sh;
  extern __shared__ int dyn[];
  int* cnt = dyn;             // this block's renderable points a cell
  int* off = dyn + L.ncell;   // the cloud's first slot a cell
  int* cur = off + L.ncell;   // this block's next slot a cell
  int* chk = cur + L.ncell;   // the cloud's first chunk a cell
  const Scratch sc = cloud_scratch(scratch, L, b);
  unsigned* keys = sc.keys;
  const size_t base = (size_t)b * L.P;
  const int chunk = (L.P + nb - 1) / nb;
  const int lo = min(L.P, rank * chunk), hi = min(L.P, lo + chunk);

  for (int i = tid; i < L.ncell; i += blockDim.x) cnt[i] = 0;
  for (int i = tid; i < 256; i += blockDim.x) sh.first[i] = 0;
  for (int i = tid; i < 512; i += blockDim.x) sh.second[i >> 8][i & 255] = 0;
  if (tid < 2) sh.count[tid] = 0;
  if (rank == 0 && tid == 0) sc.head[3] = 0;
  __syncthreads();

  // ---- the block's points: flags, zeros, keys, cells, the first round's histogram
  int n_key = 0, n_ren = 0;
  for (int p0 = lo; p0 < hi; p0 += blockDim.x) {
    const int p = p0 + tid;
    unsigned kx = kNoKey, ky = kNoKey;
    if (p < hi) {
      const size_t q = base + p;
      const float rx = radii[2 * q], ry = radii[2 * q + 1];  // loaded with the point
      float x, y;
      if (renderable(pts, vis, q, x, y)) {
        if (!isnan(rx)) kx = order_key(rx);
        if (!isnan(ry)) ky = order_key(ry);
        atomicAdd(&cnt[cell_of(x, y, L)], 1);
        ++n_ren;
      } else {
        reinterpret_cast<float2*>(out)[q] = make_float2(0.f, 0.f);
      }
      keys[2 * p] = kx;
      keys[2 * p + 1] = ky;
    }
    n_key += (kx != kNoKey) + (ky != kNoKey);
    hist_add(sh.first, kx >> 24, kx != kNoKey);
    hist_add(sh.first, ky >> 24, ky != kNoKey);
  }
  n_key = __reduce_add_sync(kFull, n_key);
  n_ren = __reduce_add_sync(kFull, n_ren);
  if (lane == 0) {
    atomicAdd(&sh.count[0], n_key);
    atomicAdd(&sh.count[1], n_ren);
  }
  cluster.sync();

  // ---- the cloud's counts, histogram and cells; this block's first slot a
  // cell is the cell's offset plus the lower ranks' points there
  if (warp == 0) {
    const int* c = cluster.map_shared_rank(sh.count, lane < nb ? lane : 0);
    const int a = __reduce_add_sync(kFull, lane < nb ? c[0] : 0);
    const int r = __reduce_add_sync(kFull, lane < nb ? c[1] : 0);
    if (lane == 0) {
      sh.total[0] = a;
      sh.total[1] = r;
    }
  }
  for (int i = tid; i < 256; i += blockDim.x) {
    int s = 0;
    for (int r = 0; r < nb; ++r) s += cluster.map_shared_rank(sh.first, r)[i];
    sh.sum[0][i] = s;
    sh.sum[1][i] = s;
  }
  for (int c = tid; c < L.ncell; c += blockDim.x) {
    int t = 0, below = 0;
    for (int r = 0; r < nb; ++r) {
      const int v = cluster.map_shared_rank(cnt, r)[c];
      t += v;
      below += r < rank ? v : 0;
    }
    off[c] = t;
    cur[c] = below;
    chk[c] = (t + kChunk - 1) / kChunk;
  }
  __syncthreads();
  const int n = sh.total[0], n_r = sh.total[1];
  // the two middle keys, 1-based ranks (n - 1) / 2 + 1 and n / 2 + 1
  int k[2] = {(n - 1) / 2 + 1, n / 2 + 1};
  unsigned pre[2] = {0u, 0u};
  if (n > 0 && warp < 2) common::radix_pick(sh.sum[warp], 0u, 24, k[warp], sh.bc[warp]);
  block_exclusive_scan(off, L.ncell, sh.scan);
  const int n_chunks = block_exclusive_scan(chk, L.ncell, sh.scan);
  for (int c = tid; c < L.ncell; c += blockDim.x) {
    cur[c] += off[c];
    if (rank == 0) {
      // the cell's offset, and its chunks of at most kChunk points
      sc.off[c] = off[c];
      const int end = c + 1 < L.ncell ? off[c + 1] : n_r;
      for (int j = 0, s0 = off[c]; s0 < end; ++j, s0 += kChunk) {
        sc.chunks[2 * (chk[c] + j)] = c;
        sc.chunks[2 * (chk[c] + j) + 1] = s0;
      }
    }
  }
  if (rank == 0 && tid == 0) {
    sc.off[L.ncell] = n_r;
    sc.head[2] = n_chunks;
  }
  if (n > 0) {
    for (int t = 0; t < 2; ++t) {
      pre[t] = (unsigned)sh.bc[t][0];
      k[t] = sh.bc[t][1];
    }
  }
  __syncthreads();

  // ---- the renderable ids into their cells' buckets, and the second
  // radix round's histograms: of lo's and, where its prefix differs, of
  // hi's (where it does not, both read lo's). The branches on n and
  // `same` are the same in every block of the cluster.
  const bool same = pre[0] == pre[1];
  for (int p0 = lo; p0 < hi; p0 += blockDim.x) {
    const int p = p0 + tid;
    float x, y;
    if (p < hi && renderable(pts, vis, base + p, x, y))
      sc.ids[atomicAdd(&cur[cell_of(x, y, L)], 1)] = p;
    for (int a = 0; n > 0 && a < 2; ++a) {
      const unsigned key = p < hi ? keys[2 * p + a] : kNoKey;
      for (int t = 0; t < (same ? 1 : 2); ++t)
        hist_add(sh.second[t], (key >> 16) & 255u, key != kNoKey && (key & 0xff000000u) == pre[t]);
    }
  }

  // ---- the second radix round over the cluster; then every key that can
  // still be a middle one (its top 16 bits lo's or hi's) to block 0's list
  if (n > 0) {
    cluster.sync();
    for (int i = tid; i < 512; i += blockDim.x) {
      const int t = i >> 8, src = same ? 0 : t;
      int s = 0;
      for (int r = 0; r < nb; ++r) s += cluster.map_shared_rank(&sh.second[src][0], r)[i & 255];
      sh.sum[t][i & 255] = s;
    }
    __syncthreads();
    if (warp < 2) common::radix_pick(sh.sum[warp], pre[warp], 16, k[warp], sh.bc[warp]);
    __syncthreads();
    for (int t = 0; t < 2; ++t) {
      pre[t] = (unsigned)sh.bc[t][0];
      k[t] = sh.bc[t][1];
    }
    for (int p0 = lo; p0 < hi; p0 += blockDim.x) {
      const int p = p0 + tid;
      for (int a = 0; a < 2; ++a) {
        const unsigned key = p < hi ? keys[2 * p + a] : kNoKey;
        const unsigned top = key & 0xffff0000u;
        const bool c = key != kNoKey && (top == pre[0] || top == pre[1]);
        const unsigned mine = __ballot_sync(kFull, c);
        int slot = 0;
        if (lane == 0 && mine) slot = atomicAdd(&sc.head[3], __popc(mine));
        slot = __shfl_sync(kFull, slot, 0);
        if (c) sc.cand[slot + __popc(mine & ((1u << lane) - 1u))] = key;
      }
    }
  }
  cluster.sync();  // the list complete; past here no block reads another's memory
  if (rank != 0) return;

  // ---- rounds 3 and 4 in block 0 alone, over the list
  if (n > 0) {
    const int n_cand = sc.head[3];
    unsigned mask = 0xffff0000u;
    for (int shift = 8; shift >= 0; shift -= 8) {
      const bool one = pre[0] == pre[1];
      for (int i = tid; i < 512; i += blockDim.x) sh.sum[i >> 8][i & 255] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n_cand; i0 += blockDim.x) {
        const unsigned key = i0 + tid < n_cand ? sc.cand[i0 + tid] : kNoKey;
        for (int t = 0; t < (one ? 1 : 2); ++t)
          hist_add(sh.sum[t], (key >> shift) & 255u, key != kNoKey && (key & mask) == pre[t]);
      }
      __syncthreads();
      if (warp < 2) common::radix_pick(sh.sum[one ? 0 : warp], pre[warp], shift, k[warp], sh.bc[warp]);
      __syncthreads();
      for (int t = 0; t < 2; ++t) {
        pre[t] = (unsigned)sh.bc[t][0];
        k[t] = sh.bc[t][1];
      }
      mask |= 255u << shift;
    }
  }

  // ---- the search radius: backward_window's float32 operations in order
  if (rank == 0 && tid == 0) {
    float mid = __uint_as_float(0x7fc00000u);  // no radius: NaN, as nanmedian gives
    if (n > 0) mid = __fmul_rn(__fadd_rn(key_value(pre[0]), key_value(pre[1])), 0.5f);
    if (isnan(mid)) {
      mid = (float)1e-3;
    } else if (isinf(mid)) {
      mid = mid > 0.f ? FLT_MAX : -FLT_MAX;
    }
    float r = __fmul_rn(mid, scaler);
    if (clamp && r > cap) r = cap;
    sc.head[0] = __float_as_int(__fmul_rn(r, r));
    sc.head[1] = n_r;
  }
}

template <bool kHalo>
__global__ void __launch_bounds__(32 * kWarps)
    walk_kernel(const float* __restrict__ pts, const float* __restrict__ radii,
                const float* __restrict__ grad, long long g_sb, long long g_sr, long long g_sc,
                Layout L, int* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float halo[];  // hs x hs cotangent, then a flag word a row
  const int b = blockIdx.y;
  const Scratch sc = cloud_scratch(scratch, L, b);
  if ((int)blockIdx.x >= sc.head[2]) return;  // past the chunks
  const int cell = sc.chunks[2 * blockIdx.x], begin = sc.chunks[2 * blockIdx.x + 1];
  const float sr2 = __int_as_float(sc.head[0]);
  const int end = min(begin + kChunk, sc.off[cell + 1]);
  const float eps = (float)1e-10;
  const int hr0 = (cell / L.nca) * L.cs, hc0 = (cell % L.nca) * L.cs;
  const float* img = grad + b * g_sb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's first point, read while the halo loads
  int e = begin + warp;
  size_t q = 0;
  float px = 0.f, py = 0.f, rx = 0.f, ry = 0.f;
  auto fetch = [&](int i) {
    q = (size_t)b * L.P + sc.ids[i];
    px = pts[3 * q];
    py = pts[3 * q + 1];
    rx = radii[2 * q];
    ry = radii[2 * q + 1];
  };
  if (e < end) fetch(e);
  unsigned* flags = reinterpret_cast<unsigned*>(halo + L.hs * L.hs);
  if (kHalo) {
    // the halo, a warp a row, its loads independent of one another
    const int hr = min(L.hs, L.S - hr0), hc = min(L.hs, L.S - hc0);
    for (int r = warp; r < hr; r += kWarps) {
      const float* src = img + (hr0 + r) * g_sr + hc0 * g_sc;
#pragma unroll 4
      for (int c = lane; c < hc; c += 32) halo[r * L.hs + c] = src[c * g_sc];
    }
    __syncthreads();
    // a row's flags: bit 0, a nonzero cotangent; bit 1, one that is not
    // positive (negative or NaN), which the positive-gradient gate keeps
    // outside a splat's box
    for (int r = warp; r < hr; r += kWarps) {
      unsigned nz = 0u, neg = 0u;
      for (int c = lane; c - lane < hc; c += 32) {
        const float v = c < hc ? halo[r * L.hs + c] : 0.f;
        nz |= __ballot_sync(kFull, v != 0.f);
        neg |= __ballot_sync(kFull, v != 0.f && !(v > 0.f));
      }
      if (lane == 0) flags[r] = (nz ? 1u : 0u) | (neg ? 2u : 0u);
    }
    __syncthreads();
  }
  for (; e < end; e += kWarps) {
    const int c0 = patch_origin(px, L.S, L.W), r0 = patch_origin(py, L.S, L.W);
    float gx = 0.f, gy = 0.f;
    auto add = [&](float g, float dx, float dx2, bool out_x, float dy, float dy2, bool out_y) {
      if (g == 0.f) return;
      const float dist2 = __fadd_rn(dx2, dy2);
      if (!(dist2 <= sr2) || (g > 0.f && (out_x || out_y))) return;
      const float denom = fmaxf(dist2, eps);
      gx = __fadd_rn(gx, __fmul_rn(__fdiv_rn(dx, denom), g));
      gy = __fadd_rn(gy, __fmul_rn(__fdiv_rn(dy, denom), g));
    };
    for (int jp = 0; jp < L.W; jp += 64) {
      // this lane's columns in the pair of 32-column chunks at jp
      const int ja = jp + lane, jb = ja + 32;
      const float dxa = __fsub_rn(common::pixel_ndc(c0 + ja, L.S, L.inv_s), px);
      const float dxb = __fsub_rn(common::pixel_ndc(c0 + jb, L.S, L.inv_s), px);
      const float dxa2 = __fmul_rn(dxa, dxa), dxb2 = __fmul_rn(dxb, dxb);
      const bool ina = ja < L.W, inb = jb < L.W;
      const bool oxa = fabsf(dxa) > rx, oxb = fabsf(dxb) > rx;
      for (int i0 = 0; i0 < L.W; i0 += 32) {
        bool take = false;
        if (i0 + lane < L.W) {
          const int row = r0 + i0 + lane;
          const float dy = __fsub_rn(common::pixel_ndc(row, L.S, L.inv_s), py);
          const unsigned f = kHalo ? flags[row - hr0] : 3u;
          take = !(__fmul_rn(dy, dy) > sr2) && (f & 1u) && ((f & 2u) || !(fabsf(dy) > ry));
        }
        for (unsigned rows = __ballot_sync(kFull, take); rows; rows &= rows - 1) {
          const int row = r0 + i0 + __ffs(rows) - 1;
          const float dy = __fsub_rn(common::pixel_ndc(row, L.S, L.inv_s), py);
          const float dy2 = __fmul_rn(dy, dy);
          const bool oy = fabsf(dy) > ry;
          const float* g_row = kHalo ? halo + (row - hr0) * L.hs : img + row * g_sr;
          const int c = kHalo ? c0 - hc0 : c0;
          const long long step = kHalo ? 1 : g_sc;
          const float ga = ina ? g_row[(c + ja) * step] : 0.f;
          const float gb = inb ? g_row[(c + jb) * step] : 0.f;
          add(ga, dxa, dxa2, oxa, dy, dy2, oy);
          add(gb, dxb, dxb2, oxb, dy, dy2, oy);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gx = __fadd_rn(gx, __shfl_down_sync(kFull, gx, o));
      gy = __fadd_rn(gy, __shfl_down_sync(kFull, gy, o));
    }
    if (lane == 0) reinterpret_cast<float2*>(out)[q] = make_float2(gx, gy);
    if (e + kWarps < end) fetch(e + kWarps);  // the next point, read ahead
  }
}

}  // namespace

// Scratch ints a cloud for P points: the head (search_r2's float bits, the
// renderable points, the chunks, the candidate keys), then `Scratch`'s
// arrays.
extern "C" long long occ_scratch_ints(int P) { return 5 + 7LL * P + 3LL * kMaxCells; }

// B clouds: pts (B, P, 3) float32 [x_ndc, y_ndc, depth], radii (B, P, 2)
// float32, visible (B, P) bool bytes, all contiguous; grad the occupancy
// cotangent, element (b, i, j) at grad[b * g_sb + i * g_sr + j * g_sc];
// -> out (B, P, 2) float32. 1 <= W <= S; inv_s = 1/S, scaler
// (`radii_backward_scaler`) and cap ((W/2 - 2) * 2/S, applied when clamp
// is nonzero) rounded to float. scratch: at least B * occ_scratch_ints(P)
// ints (scratch_ints); cloud b's part starts at b * occ_scratch_ints(P),
// ints 0 and 1 search_r2 (float bits) and the count n of renderable
// points, ints 4 to 4 + n their ids in walk order (`Scratch`).
extern "C" int occ_backward(const float* pts, const float* radii, const unsigned char* visible,
                            const float* grad, long long g_sb, long long g_sr, long long g_sc,
                            int B, int P, int S, int W, float inv_s, float scaler, float cap,
                            int clamp, float* out, int* scratch, long long scratch_ints,
                            void* stream) {
  if (B < 0 || P < 0 || S < 1 || W < 1 || W > S) return (int)cudaErrorInvalidValue;
  Layout L;
  L.P = P;
  L.S = S;
  L.W = W;
  L.inv_s = inv_s;
  L.cs = kCell;
  for (;;) {
    L.nca = (S - W) / L.cs + 1;
    if (L.nca * L.nca <= kMaxCells) break;
    L.cs *= 2;
  }
  L.ncell = L.nca * L.nca;
  L.hs = min(L.cs + W - 1, S);
  L.per = occ_scratch_ints(P);
  if ((long long)B * L.per > scratch_ints) return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  static int win_limit = -1;
  const int win_smem = 4 * L.ncell * (int)sizeof(int);
  cudaError_t err = common::allow_dynamic_smem(window_kernel, win_smem, win_limit);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kWinCluster, B);
  cfg.blockDim = dim3(kWinThreads);
  cfg.dynamicSmemBytes = win_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kWinCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, window_kernel, pts, radii, visible, L, scaler, cap, clamp, out,
                           scratch);
  if (err != cudaSuccess) return (int)err;

  static int max_smem = -1;
  if (max_smem < 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int halo_smem = (L.hs * L.hs + L.hs) * 4;
  const bool use_halo = halo_smem <= max_smem;
  const dim3 grid((P + kChunk - 1) / kChunk + L.ncell, B);  // at least the chunks
  if (use_halo) {
    static int walk_limit = -1;
    err = common::allow_dynamic_smem(walk_kernel<true>, halo_smem, walk_limit);
    if (err != cudaSuccess) return (int)err;
    walk_kernel<true><<<grid, 32 * kWarps, halo_smem, st>>>(pts, radii, grad, g_sb, g_sr, g_sc, L,
                                                            scratch, out);
  } else {
    walk_kernel<false><<<grid, 32 * kWarps, 0, st>>>(pts, radii, grad, g_sb, g_sr, g_sc, L,
                                                     scratch, out);
  }
  return (int)cudaGetLastError();
}
