// Splat candidate selection: per strip of tiles, then per tile, the
// front-most splats whose bounding box touches it, up to capacity.
//
// Replaces `_select_kernel` (isopoints_tpu/rendering/pallas_select.py:73,
// reached by `select_candidates_pallas` :258, pallas_call :302). Same
// contract as the plain `select_candidates_plain` (rendering/select.py, the
// `_tile_candidates` rows of isopoints_tpu/rendering/rasterizer.py:293):
// the SET of candidates of each tile equals `lax.top_k`'s on -z (every
// splat strictly in front of the capacity threshold, then threshold ties in
// index order), and the overflow count is the same. The order inside a
// tile's list is index order, which may differ from the plain version's
// depth order; the fine stage breaks depth ties by point index, so the
// fragment maps do not depend on it.
//
// Bound on an H100: bytes. The work is a few compares per splat and strip;
// the least traffic is reading the six (P,) inputs once and writing the
// (nt^2, M) candidate table.
//
// Design: a thread-block cluster per strip (tile row) and cloud, kCluster
// = 8 blocks of 256 threads (the portable cluster size), so the grid has
// 8 x nt x B blocks (256 at nt = 16, B = 2 and at nt = 32, B = 1) where one
// block per strip left most of the card idle. The TPU's integer bisection,
// triangular-matmul prefix sums and one-hot extraction dots are MXU
// workarounds; here the capacity threshold is the k-th smallest depth
// found by a 4-round 8-bit radix select on the depth bits (non-negative
// floats order as their bit patterns), run only when a strip or tile holds
// more than its capacity, and compaction is by warp ballots.
//  - Strip phase, split over the cluster: block r scans the r-th of 8
//    contiguous ranges of splats, each warp a contiguous part of it. The
//    blocks exchange their counts (and, when the strip overflows, each
//    round's histograms and their strict and tie counts) through
//    distributed shared memory, so every block knows the offset of its
//    part in the strip's list and the threshold ties that fall to it; each
//    warp then places its taken splats with two ballots and writes them
//    into the list of every block of the cluster. The list (x, x-radius,
//    depth bits, index; 16 bytes an entry) stays in index order.
//  - Tile phase: each block runs the same count / select / ballot
//    compaction on its own list for its nt / 8 tiles, up to four tiles a
//    pass over the list, writing the candidate table.
// Barriers: one block barrier per warp-count exchange, one cluster barrier
// per exchange between the blocks; none inside the compaction loops.
// `isopoints_torch.kernel_variants` builds copies with other cluster sizes
// and block widths, and a two-kernel arrangement, for the measurements.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() (or the launch's error) after the launch.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;  // blocks a strip
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAll = 0xffffffffu;  // threshold meaning "take every overlap"

// depth bits that order as the depth does (z >= 0; -0 maps to +0)
__device__ __forceinline__ unsigned depth_key(float z) { return __float_as_uint(z) & 0x7fffffffu; }

// The six per-splat inputs of one launch: px, py, z, rx, ry (float) and
// valid (byte), each with its cloud and point strides in elements.
struct Splats {
  const float* f[5];
  const unsigned char* valid;
  long long sb[6], sp[6];
};

// A strip's list, in index order: x, x-radius, depth key and point index.
struct List {
  float* px;
  float* rx;
  unsigned* key;
  int* idx;
};

constexpr int kTileGroup = 4;  // tiles a pass over a strip's list serves

struct Shared {
  int hist[2][256];   // radix histograms, two so that a round needs one cluster barrier
  int tot[256];       // the cluster's histogram of a round
  int bcast[2];
  int warp[kWarps][3];  // per warp: overlaps, strictly in front, at the threshold
  int part[3];          // the same for the block, read by the cluster
  int tile[kTileGroup][kWarps][3];  // the same per warp for each tile of a group
};

// The part [lo, hi) of [n0, n1) that this thread's warp walks: contiguous,
// in warp order, a multiple of 32 long.
__device__ __forceinline__ void warp_range(int n0, int n1, int& lo, int& hi) {
  const int per = ((n1 - n0 + kWarps - 1) / kWarps + 31) & ~31;
  lo = min(n1, n0 + (int)(threadIdx.x >> 5) * per);
  hi = min(n1, lo + per);
}

// Counts over the warp's range of the elements with pred(e), of those with
// key < v and with key == v, to sh.warp[warp] (lane 0). No barrier.
template <class Pred, class Key>
__device__ void warp_counts(Pred pred, Key key_of, int lo, int hi, unsigned v, Shared& sh) {
  int n = 0, strict = 0, tie = 0;
#pragma unroll 4
  for (int e = lo + (threadIdx.x & 31); e < hi; e += 32) {
    const bool in = pred(e);
    const unsigned key = in ? key_of(e) : kAll;
    n += in;
    strict += in && key < v;
    tie += in && key == v;
  }
  n = __reduce_add_sync(kFull, n);
  strict = __reduce_add_sync(kFull, strict);
  tie = __reduce_add_sync(kFull, tie);
  if ((threadIdx.x & 31) == 0) {
    int* w = sh.warp[threadIdx.x >> 5];
    w[0] = n;
    w[1] = strict;
    w[2] = tie;
  }
}

// Walk the warp's range [lo, hi) in index order and emit every e with
// pred(e) and key < v, and each tie (key == v) whose rank among the
// list's ties (tie_base of them come before this range) is below n_tie,
// at consecutive slots from `slot`. The lanes of a warp call it together;
// the ballots sit outside every data-dependent condition.
template <class Pred, class Key, class Emit>
__device__ void warp_compact(Pred pred, Key key_of, int lo, int hi, unsigned v, int tie_base,
                             int n_tie, int slot, Emit emit) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int e = base + (int)lane;
    const bool ok = e < hi && pred(e);
    const unsigned key = ok ? key_of(e) : 0u;
    const bool tie = ok && key == v;
    const unsigned ties = __ballot_sync(kFull, tie);
    const bool taken = (ok && key < v) || (tie && tie_base + __popc(ties & below) < n_tie);
    const unsigned takes = __ballot_sync(kFull, taken);
    if (taken) emit(e, slot + __popc(takes & below));
    tie_base += __popc(ties);
    slot += __popc(takes);
  }
}

// This warp's first slot and the threshold ties before its range, from the
// block's per-warp counts (after a barrier) and the block's own offsets.
__device__ __forceinline__ void warp_offsets(const Shared& sh, int n_tie, int& slot,
                                             int& ties_before) {
  for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) {
    slot += sh.warp[w][1] + max(0, min(n_tie - ties_before, sh.warp[w][2]));
    ties_before += sh.warp[w][2];
  }
}

// The k-th smallest key among the keys key_of(e) of the elements pred(e)
// of every block's range [lo, hi) in the cluster, by four rounds of 8-bit
// radix selection; on return k is that element's rank among the ties of its
// key. Each block builds its histogram of a round, the cluster sums them
// through distributed shared memory. Every thread of the cluster calls it.
template <class Pred, class Key>
__device__ unsigned cluster_radix_select(cg::cluster_group& cluster, Pred pred, Key key_of,
                                         int lo, int hi, int& k, Shared& sh) {
  const int n_blocks = (int)cluster.num_blocks();
  unsigned prefix = 0u, mask = 0u;
  for (int round = 0; round < 4; ++round) {
    const int shift = 24 - 8 * round;
    // two buffers: the peers read this one two rounds ago, before the last
    // round's cluster barrier, which every block has passed
    int* h = sh.hist[round & 1];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) h[i] = 0;
    __syncthreads();
    for (int e = lo + threadIdx.x; e < hi; e += blockDim.x) {
      if (!pred(e)) continue;
      const unsigned key = key_of(e);
      if ((key & mask) == prefix) atomicAdd(&h[(key >> shift) & 255u], 1);
    }
    cluster.sync();
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      int s = 0;
      for (int r = 0; r < n_blocks; ++r) s += cluster.map_shared_rank(h, r)[i];
      sh.tot[i] = s;
    }
    __syncthreads();
    if (threadIdx.x < 32) common::radix_pick(sh.tot, prefix, shift, k, sh.bcast);
    __syncthreads();
    prefix = (unsigned)sh.bcast[0];
    k = sh.bcast[1];
    mask |= 255u << shift;
  }
  return prefix;
}

// The candidates of tiles tj0 .. tj0 + n - 1 (n <= kTileGroup) of strip g
// from the strip's list `l` (k_s entries; count_s splats overlapped the
// strip): per tile the M front-most overlapping it, in list order, then
// padding (index 0, not ok); each tile's overflow, with the strip's on its
// first tile. One pass over the list counts every tile's overlaps, one
// more places every tile's candidates (a tile past M first finds its
// threshold by a block radix select and counts again). Every thread of the
// block calls it.
__device__ void tile_group(const List& l, int k_s, int count_s, int b, int g, int tj0, int n,
                           int S, int T, int nt, int R, int M, float inv_s, float half,
                           Shared& sh, long long* __restrict__ cidx,
                           unsigned char* __restrict__ cok, long long* __restrict__ ovf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  float cx[kTileGroup];
#pragma unroll
  for (int j = 0; j < kTileGroup; ++j)
    cx[j] = 0.5f * (common::pixel_ndc((tj0 + j) * T, S, inv_s) +
                    common::pixel_ndc((tj0 + j) * T + T - 1, S, inv_s));
  auto in_tile = [&](int j, int e) { return j < n && fabsf(l.px[e] - cx[j]) <= l.rx[e] + half; };
  int lo, hi;
  warp_range(0, k_s, lo, hi);
  int cnt[kTileGroup] = {};
  for (int e = lo + lane; e < hi; e += 32) {
    const float x = l.px[e], r = l.rx[e] + half;
#pragma unroll
    for (int j = 0; j < kTileGroup; ++j) cnt[j] += j < n && fabsf(x - cx[j]) <= r;
  }
#pragma unroll
  for (int j = 0; j < kTileGroup; ++j) {
    const int c = __reduce_add_sync(kFull, cnt[j]);
    if (lane == 0) {
      sh.tile[j][warp][0] = c;
      sh.tile[j][warp][1] = c;
      sh.tile[j][warp][2] = 0;
    }
  }
  __syncthreads();
  int count_t[kTileGroup], n_tie[kTileGroup];
  unsigned v[kTileGroup];
#pragma unroll
  for (int j = 0; j < kTileGroup; ++j) {
    count_t[j] = 0;
    for (int w = 0; w < kWarps; ++w) count_t[j] += sh.tile[j][w][0];
    v[j] = kAll;
    n_tie[j] = 0;
  }
#pragma unroll
  for (int j = 0; j < kTileGroup; ++j) {
    if (j >= n || count_t[j] <= M) continue;  // the same branch in every thread
    int k = M;
    auto keyed = [&](int e, unsigned& kk) {
      if (!in_tile(j, e)) return false;
      kk = l.key[e];
      return true;
    };
    const unsigned vj = common::block_radix_select(keyed, k_s, k, sh.hist[0], sh.bcast);
    int strict = 0, tie = 0;
    for (int e = lo + lane; e < hi; e += 32) {
      const bool in = in_tile(j, e);
      strict += in && l.key[e] < vj;
      tie += in && l.key[e] == vj;
    }
    strict = __reduce_add_sync(kFull, strict);
    tie = __reduce_add_sync(kFull, tie);
    if (lane == 0) {
      sh.tile[j][warp][1] = strict;
      sh.tile[j][warp][2] = tie;
    }
    __syncthreads();
    v[j] = vj;
    n_tie[j] = k;
  }
  int slot[kTileGroup], ties_before[kTileGroup];
#pragma unroll
  for (int j = 0; j < kTileGroup; ++j) {
    slot[j] = 0;
    ties_before[j] = 0;
    for (int w = 0; w < warp; ++w) {
      slot[j] += sh.tile[j][w][1] + max(0, min(n_tie[j] - ties_before[j], sh.tile[j][w][2]));
      ties_before[j] += sh.tile[j][w][2];
    }
  }
  const size_t row0 = (((size_t)b * nt + g) * nt + tj0) * M;
  for (int base = lo; base < hi; base += 32) {
    const int e = base + lane;
    const bool live = e < hi;
    const float x = live ? l.px[e] : 0.f, r = live ? l.rx[e] + half : -1.f;
    const unsigned key = live ? l.key[e] : 0u;
    const int idx = live ? l.idx[e] : 0;
#pragma unroll
    for (int j = 0; j < kTileGroup; ++j) {
      const bool ok = j < n && fabsf(x - cx[j]) <= r;
      const bool tie = ok && key == v[j];
      const unsigned ties = __ballot_sync(kFull, tie);
      const bool taken =
          (ok && key < v[j]) || (tie && ties_before[j] + __popc(ties & below) < n_tie[j]);
      const unsigned takes = __ballot_sync(kFull, taken);
      if (taken) {
        const size_t at = row0 + (size_t)j * M + slot[j] + __popc(takes & below);
        cidx[at] = idx;
        cok[at] = 1;
      }
      ties_before[j] += __popc(ties);
      slot[j] += __popc(takes);
    }
  }
#pragma unroll
  for (int j = 0; j < kTileGroup; ++j) {
    if (j >= n) break;
    for (int m = min(M, count_t[j]) + threadIdx.x; m < M; m += blockDim.x) {
      cidx[row0 + (size_t)j * M + m] = 0;
      cok[row0 + (size_t)j * M + m] = 0;
    }
    if (threadIdx.x == 0)
      ovf[((size_t)b * nt + g) * nt + tj0 + j] =
          max(count_t[j] - M, 0) + (tj0 + j == 0 ? max(count_s - R, 0) : 0);
  }
  __syncthreads();  // sh.tile is the next group's
}

// The whole selection: the strip's list in every block's shared memory,
// then each block's share of the strip's tiles.
__global__ void __launch_bounds__(kThreads)
    select_kernel(Splats in, int P, int S, int T, int nt, int R, int M, float inv_s, float half,
                  long long* __restrict__ cidx, unsigned char* __restrict__ cok,
                  long long* __restrict__ ovf) {
  extern __shared__ unsigned char smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  // the cluster's size read at run time: loops over a constant 8 blocks
  // unroll and take twice the registers
  const int n_blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.x / n_blocks;  // strip = tile row
  const int b = blockIdx.y;
  const float* px = in.f[0] + b * in.sb[0];
  const float* py = in.f[1] + b * in.sb[1];
  const float* z = in.f[2] + b * in.sb[2];
  const float* rx = in.f[3] + b * in.sb[3];
  const float* ry = in.f[4] + b * in.sb[4];
  const unsigned char* valid = in.valid + b * in.sb[5];
  const float cy =
      0.5f * (common::pixel_ndc(g * T, S, inv_s) + common::pixel_ndc(g * T + T - 1, S, inv_s));

  // ---- strip phase: the R front-most splats overlapping the tile row
  // both tests always evaluated, so the three loads issue together
  auto in_strip = [&](int i) -> bool {
    return (valid[i * in.sp[5]] != 0) & (fabsf(py[i * in.sp[1]] - cy) <= ry[i * in.sp[4]] + half);
  };
  auto zkey = [&](int i) { return depth_key(z[i * in.sp[2]]); };
  const int chunk = (P + n_blocks - 1) / n_blocks;
  const int lo = min(P, rank * chunk), hi = min(P, lo + chunk);
  int wlo, whi;
  warp_range(lo, hi, wlo, whi);
  warp_counts(in_strip, zkey, wlo, whi, kAll, sh);
  __syncthreads();
  if (threadIdx.x < 3) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += sh.warp[w][threadIdx.x];
    sh.part[threadIdx.x] = s;
  }
  cluster.sync();
  int count_s = 0;
  for (int r = 0; r < n_blocks; ++r) count_s += cluster.map_shared_rank(sh.part, r)[0];
  unsigned v = kAll;
  int n_tie = 0;
  if (count_s > R) {  // the same branch in every block of the cluster
    int k = R;
    v = cluster_radix_select(cluster, in_strip, zkey, lo, hi, k, sh);
    n_tie = k;
    warp_counts(in_strip, zkey, wlo, whi, v, sh);
    __syncthreads();
    if (threadIdx.x < 3) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += sh.warp[w][threadIdx.x];
      sh.part[threadIdx.x] = s;
    }
    cluster.sync();
  }
  // this block's first slot in the list: the lower ranks' taken splats
  int slot = 0, ties_before = 0;
  for (int r = 0; r < rank; ++r) {
    const int* pr = cluster.map_shared_rank(sh.part, r);
    slot += pr[1] + max(0, min(n_tie - ties_before, pr[2]));
    ties_before += pr[2];
  }
  warp_offsets(sh, n_tie, slot, ties_before);
  List own;
  own.px = reinterpret_cast<float*>(smem);
  own.rx = own.px + R;
  own.key = reinterpret_cast<unsigned*>(own.rx + R);
  own.idx = reinterpret_cast<int*>(own.key + R);
  warp_compact(in_strip, zkey, wlo, whi, v, ties_before, n_tie, slot, [&](int i, int s) {
    const float x = px[i * in.sp[0]], r_x = rx[i * in.sp[3]];
    const unsigned key = zkey(i);
    for (int r = 0; r < n_blocks; ++r) {
      cluster.map_shared_rank(own.px, r)[s] = x;
      cluster.map_shared_rank(own.rx, r)[s] = r_x;
      cluster.map_shared_rank(own.key, r)[s] = key;
      cluster.map_shared_rank(own.idx, r)[s] = i;
    }
  });
  // every list complete; past this barrier no block reads another's memory
  cluster.sync();

  // ---- tile phase on the block's copy of the list, its share of the tiles
  const int k_s = min(R, count_s);
  const int per = (nt + n_blocks - 1) / n_blocks;
  const int tj_end = min(nt, rank * per + per);
  for (int tj = rank * per; tj < tj_end; tj += kTileGroup)
    tile_group(own, k_s, count_s, b, g, tj, min(kTileGroup, tj_end - tj), S, T, nt, R, M, inv_s,
               half, sh, cidx, cok, ovf);
}

}  // namespace

// Per cloud b of B: px, py, z, rx, ry float32 and valid (bool bytes, must
// already include z >= 0), element b, i of input j at
// ptr_j + strides[j] * b + strides[6 + j] * i. S image size (inv_s = 1/S
// rounded to float), T tile size, nt = S / T, half = (T - 1)/S, R strip
// capacity (<= P), M tile capacity (<= R). Outputs cidx (B, nt, nt, M)
// int64 point indices, cok (B, nt, nt, M) bool bytes, ovf (B, nt, nt)
// int64 per tile (a strip's own overflow on its first tile): the cloud's
// overflow is their sum.
extern "C" int select_candidates(const float* px, const float* py, const float* z,
                                 const float* rx, const float* ry, const unsigned char* valid,
                                 const long long* strides, int B, int P, int S, int T, int nt,
                                 int R, int M, float inv_s, float half, long long* cidx,
                                 unsigned char* cok, long long* ovf, void* stream) {
  if (B < 0 || P < 1 || T < 1 || nt < 1 || R < 1 || M < 1 || M > R || R > P)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Splats in = {{px, py, z, rx, ry}, valid, {}, {}};
  for (int j = 0; j < 6; ++j) {
    in.sb[j] = strides[j];
    in.sp[j] = strides[6 + j];
  }
  static int smem_limit = -1;
  const int smem = R * 16;
  const cudaError_t err_smem = common::allow_dynamic_smem(select_kernel, smem, smem_limit);
  if (err_smem != cudaSuccess) return (int)err_smem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * nt, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, select_kernel, in, P, S, T, nt, R, M, inv_s,
                                             half, cidx, cok, ovf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
