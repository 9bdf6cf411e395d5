// Exact masked k-nearest neighbours, k <= 32.
//
// Replaces `_knn_kernel` (isopoints_tpu/ops/pallas_knn.py:83, reached by
// `knn_points_pallas` :286 through `_knn_flat`, pallas_call :255).
//
// Bound on an H100: operations. Every query meets every point: 8 FLOP for
// the expanded distance plus a compare, against 16 bytes a point and 12
// bytes + k entries a query, so N*P distance evaluations at the f32 CUDA-core
// rate bound it (at P = N = 8000 that is ~0.5 GFLOP, ~8 us at 67 TFLOP/s).
//
// Design. The path's calls are small (P = N = 3000, k = 8, 19 times a
// projected step), so one thread per query left most of the card idle. Here
// a group of G lanes serves one query: G = 16 for k <= 16 (two queries a
// warp), G = 32 for 16 < k <= 32 (a warp a query); k itself is a runtime
// argument, so the library holds two instances. The points stream through
// shared memory in tiles of G * kBlock (x, y, z, |p|^2; |p|^2 = -1 marks a
// masked point), lane l of a group scanning points l, l + G, ... of each
// tile. The group keeps one sorted list of the query's k best, ordered by
// (distance, index), one entry a lane (lane s holds entry s; k <= G), so
// its k-th entry is an exact bound: a lane's point is a candidate only if
// it ranks before that entry, which after the first few points is rare.
// The lanes compute kBlock / G distances each (a block of kBlock = 64
// points), then one ballot asks whether any of them is a candidate; if so the
// group inserts its candidates one at a time (the first by lane, then by
// step): a ballot of the entries ranking before the candidate gives its
// place, the entries from there on move up one lane (a shuffle), and the
// k-th entry, the bound, is shuffled to every lane again. (distance, index)
// is a total order, so the list is the same whatever lane scanned which
// point and in what order: equal distances keep the lower index first, as
// the dense path's first-occurrence argmin does.
//
// Pruning, for large clouds (the TPU kernel's Morton sort and chunk
// pruning). The wrapper orders the points (and self-queries) by the Morton
// code of their cell (`knn_morton`, then a sort), `knn_boxes` takes the
// bounding box of every block of kBlock = 64 consecutive points of that
// order, and the kernel reads points and queries through the order: each
// block of queries starts at the tile that holds them, lane c of a group
// tests block c of each tile against the group's bound (`box_floor`), a
// tile no query of the block needs is never loaded, and a block neither
// query of a warp needs is never scanned. Indices and ties stay those of
// the caller's order.
//
// The squared distance is the dense path's expansion |q|^2 + |p|^2 - 2 q.p,
// clamped at 0, with the norms and the dot product as the fused
// multiply-add chains fma(z, z', fma(y, y', x x')) the plain version (and
// XLA on the CPU) forms, and the remaining sums rounded on their own
// (__fadd_rn: nvcc would otherwise contract them), so the distances agree
// bit for bit with the plain version and near-ties rank the same.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;  // points under one box and one ballot
constexpr float kBig = 1e10f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                     float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// (d, i) ranks strictly before (e, j): nearer, or as near with a lower index
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// the caller's index of the i-th point or query of a cloud in the kernel's
// order (`order` null: the same)
__device__ __forceinline__ int caller_index(const long long* order, size_t row, int i) {
  return order ? (int)order[row + i] : i;
}

// each 10-bit integer with its bits spread three apart (bit i to 3i)
__device__ __forceinline__ unsigned spread10(unsigned x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  return (x | (x << 2)) & 0x09249249u;
}

// Morton code of each point's cell on a 1024^3 grid over the unmasked
// points' bounding box (masked points: 2^30, after all). One block a cloud.
__global__ void __launch_bounds__(1024)
    knn_morton(const float* __restrict__ points, const unsigned char* __restrict__ pmask,
               int p, int* __restrict__ code) {
  __shared__ float red[6][32];
  const int b = blockIdx.x;
  const float* pts = points + (size_t)b * p * 3;
  const unsigned char* pm = pmask + (size_t)b * p;
  // lo xyz, then -hi xyz, as minima
  float v[6] = {INFINITY, INFINITY, INFINITY, INFINITY, INFINITY, INFINITY};
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    if (pm[j])
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = fminf(v[a], pts[3 * j + a]);
        v[3 + a] = fminf(v[3 + a], -pts[3 * j + a]);
      }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[a] = fminf(v[a], __shfl_xor_sync(kAll, v[a], off));
    if ((threadIdx.x & 31) == 0) red[a][threadIdx.x >> 5] = v[a];
  }
  __syncthreads();
  // every warp reduces the warps' minima, so every thread holds the box
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    v[a] = (threadIdx.x & 31) < (blockDim.x >> 5) ? red[a][threadIdx.x & 31] : INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[a] = fminf(v[a], __shfl_xor_sync(kAll, v[a], off));
  }
  float scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) scale[a] = 1023.f / fmaxf(-v[3 + a] - v[a], 1e-30f);
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    unsigned c = 1u << 30;
    if (pm[j]) {
      c = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t = fminf(fmaxf((pts[3 * j + a] - v[a]) * scale[a], 0.f), 1023.f);
        c |= spread10((unsigned)t) << a;
      }
    }
    code[(size_t)b * p + j] = (int)c;
  }
}

// The bounding box of each block of kBlock points in the order `order`:
// lo xyz, hi xyz, the largest |p|^2 over its corners, and 1 where it holds
// no unmasked point. One warp a block.
__global__ void __launch_bounds__(256)
    knn_boxes(const float* __restrict__ points, const unsigned char* __restrict__ pmask,
              const long long* __restrict__ order, int p, float* __restrict__ box) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int n_blocks = (p + kBlock - 1) / kBlock;
  if (c >= n_blocks) return;
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int h = 0; h < kBlock / 32; ++h) {
    const int i = c * kBlock + h * 32 + (threadIdx.x & 31);
    if (i < p) {
      const int j = caller_index(order, (size_t)b * p, i);
      if (pmask[(size_t)b * p + j])
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = points[((size_t)b * p + j) * 3 + a];
          lo[a] = fminf(lo[a], x);
          hi[a] = fmaxf(hi[a], x);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kAll, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kAll, hi[a], off));
    }
  if ((threadIdx.x & 31) == 0) {
    float* o = box + ((size_t)b * n_blocks + c) * 8;
    float far2 = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = lo[a];
      o[3 + a] = hi[a];
      far2 += fmaxf(lo[a] * lo[a], hi[a] * hi[a]);
    }
    o[6] = far2;
    o[7] = lo[0] > hi[0] ? 1.f : 0.f;
  }
}

// The least a computed distance from q to a point of the box can be, less
// a margin: a block whose floor is strictly above the bound holds no
// candidate (+inf: a block without unmasked points). With u = 2^-24, a
// computed distance is at least D (1 - u) - 7u (|q|^2 + |p|^2) for the
// exact D (|q|^2, |p|^2 and q.p each three roundings, their sum and
// difference one each), and the computed bound lb at most D (1 + 5u) for
// every point of the box, so every computed distance there is at least
// lb (1 - 6u) - 7u (|q|^2 + far^2) > lb - 1e-6 (lb + |q|^2 + far^2)
// (far^2: the box's largest |p|^2). A distance equal to the bound is never
// skipped, so a lower index still wins a tie.
__device__ __forceinline__ float box_floor(const float* o, float qx, float qy, float qz,
                                           float qsq) {
  if (o[7] != 0.f) return INFINITY;
  const float dx = fmaxf(fmaxf(o[0] - qx, qx - o[3]), 0.f);
  const float dy = fmaxf(fmaxf(o[1] - qy, qy - o[4]), 0.f);
  const float dz = fmaxf(fmaxf(o[2] - qz, qz - o[5]), 0.f);
  const float lb = dx * dx + dy * dy + dz * dz;
  return lb - 1e-6f * (lb + qsq + o[6]);
}

// query/qmask (B, n), points/pmask (B, p) in the caller's order; qorder
// (B, n) and porder (B, p): the kernel's order of each (null: the
// caller's); box (B, ceil(p / kBlock), 8): the blocks' boxes in porder
// (null: no pruning). kGroup lanes a query, 1 <= k <= kGroup.
template <int kGroup>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ query, const unsigned char* __restrict__ qmask,
               const float* __restrict__ points, const unsigned char* __restrict__ pmask,
               const long long* __restrict__ qorder, const long long* __restrict__ porder,
               const float* __restrict__ box, int n, int p, int k, int exclude_self,
               float* __restrict__ out_d, long long* __restrict__ out_i) {
  static_assert(kGroup == 16 || kGroup == 32, "a half warp or a warp a query");
  constexpr int kQueries = kThreads / kGroup;  // per block
  constexpr int kSteps = kBlock / kGroup;      // points a lane scans between two ballots
  constexpr int kTile = kGroup * kBlock;       // lane c of a group tests block c of a tile
  __shared__ float4 tile[kTile];
  __shared__ int tile_idx[kTile];  // each staged point's index in the caller's order
  const int b = blockIdx.y;
  const int lane = threadIdx.x % kGroup;
  const int base_lane = (threadIdx.x & 31) - lane;  // the group's first lane in the warp
  const unsigned gmask = kGroup == 32 ? kAll : ((1u << kGroup) - 1) << base_lane;
  const int qs = blockIdx.x * kQueries + threadIdx.x / kGroup;  // in the kernel's order
  // the query's index in the caller's order: its output row, and the point
  // exclude_self drops
  const int qi = qs < n ? caller_index(qorder, (size_t)b * n, qs) : -1;
  // uniform over a group; groups of one warp may differ, so every shuffle,
  // vote, ballot and barrier below is reached by the whole block
  const bool active = qi >= 0 && qmask[(size_t)b * n + qi] != 0;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = query + ((size_t)b * n + qi) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float qsq = dot3(qx, qy, qz, qx, qy, qz);

  // this lane's entry of the group's list, and the list's k-th entry (the
  // bound); an empty entry is (inf, INT_MAX), after every real candidate
  float ed = INFINITY, bd = INFINITY;
  int ei = INT_MAX, bi = INT_MAX;

  // from the tile at the block's queries' place on: in the kernel's order
  // the points near them come first
  const int n_tiles = (p + kTile - 1) / kTile;
  const int n_blocks = (p + kBlock - 1) / kBlock;
  const int t0 = (int)((long long)blockIdx.x * kQueries * p / n / kTile);
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int base = ((t0 + tt) % n_tiles) * kTile;
    const int cnt = min(kTile, p - base);
    // lane c's floor of block c of the tile for the group's query
    const int c = base / kBlock + lane;
    const float floor_c =
        box == nullptr ? -INFINITY
        : c < n_blocks ? box_floor(box + ((size_t)b * n_blocks + c) * 8, qx, qy, qz, qsq)
                       : INFINITY;
    // a barrier: also the end of the last tile's reads
    if (!__syncthreads_or(active && !(floor_c > bd))) continue;
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const int j = caller_index(porder, (size_t)b * p, base + e);
      const float* pt = points + ((size_t)b * p + j) * 3;
      const float x = pt[0], y = pt[1], z = pt[2];
      tile[e] = make_float4(x, y, z, pmask[(size_t)b * p + j] ? dot3(x, y, z, x, y, z) : -1.f);
      tile_idx[e] = j;
    }
    __syncthreads();
    for (int e0 = 0; e0 < cnt; e0 += kBlock) {
      // skipped when neither query of the warp needs the block (the
      // shuffle outside the condition: every lane of the warp takes part)
      const float floor_e0 = __shfl_sync(kAll, floor_c, base_lane + e0 / kBlock);
      const bool skip = !active || floor_e0 > bd;
      if (__all_sync(kAll, skip)) continue;
      float d[kSteps];
      int jo[kSteps];
      bool cand[kSteps];
      bool any = false;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int e = e0 + s * kGroup + lane;
        const int ec = min(e, cnt - 1);
        const float4 pt = tile[ec];
        jo[s] = tile_idx[ec];
        const float dot = dot3(qx, qy, qz, pt.x, pt.y, pt.z);
        d[s] = fmaxf(__fsub_rn(__fadd_rn(qsq, pt.w), __fmul_rn(2.f, dot)), 0.f);
        cand[s] = !skip && e < cnt && pt.w >= 0.f && !(exclude_self && jo[s] == qi) &&
                  before(d[s], jo[s], bd, bi);
        any |= cand[s];
      }
      if (!__any_sync(kAll, any)) continue;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        for (unsigned ball = __ballot_sync(kAll, cand[s]); ball;
             ball = __ballot_sync(kAll, cand[s])) {
          // the group's first candidate lane, or none (then nothing moves)
          const unsigned mine = ball & gmask;
          const int src = mine ? __ffs(mine) - 1 : (threadIdx.x & 31);
          const float cd = __shfl_sync(kAll, d[s], src);
          const int ci = __shfl_sync(kAll, jo[s], src);
          const bool ins = mine != 0 && before(cd, ci, bd, bi);
          const int pos = __popc(__ballot_sync(kAll, before(ed, ei, cd, ci)) & gmask);
          const float ud = __shfl_up_sync(kAll, ed, 1, kGroup);
          const int ui = __shfl_up_sync(kAll, ei, 1, kGroup);
          if (ins && lane >= pos) {
            ed = lane == pos ? cd : ud;
            ei = lane == pos ? ci : ui;
          }
          bd = __shfl_sync(kAll, ed, base_lane + k - 1);
          bi = __shfl_sync(kAll, ei, base_lane + k - 1);
          if ((threadIdx.x & 31) == src) cand[s] = false;
          cand[s] = cand[s] && before(d[s], jo[s], bd, bi);
        }
      }
    }
  }

  if (qi >= 0 && lane < k) {
    const size_t o = ((size_t)b * n + qi) * k + lane;
    const bool full = ei != INT_MAX;
    out_d[o] = full ? ed : kBig;
    out_i[o] = full ? ei : -1;
  }
}

template <int kGroup>
int launch(const float* q, const unsigned char* qm, const float* p, const unsigned char* pm,
           const long long* qorder, const long long* porder, const float* box, int bsz, int n,
           int np, int k, int exclude_self, float* d, long long* i, cudaStream_t s) {
  constexpr int kQueries = kThreads / kGroup;
  const dim3 grid((n + kQueries - 1) / kQueries, bsz);
  knn_kernel<kGroup><<<grid, kThreads, 0, s>>>(q, qm, p, pm, qorder, porder, box, n, np, k,
                                               exclude_self, d, i);
  return (int)cudaGetLastError();
}

}  // namespace

// points (B, np, 3), pmask (B, np) -> code (B, np) int32: the Morton code of
// each point's cell over its cloud's unmasked box (masked: 2^30).
extern "C" int knn_morton_codes(const float* points, const unsigned char* pmask, int bsz, int np,
                                int* code, void* stream) {
  if (bsz < 0 || np < 0) return (int)cudaErrorInvalidValue;
  if (bsz == 0 || np == 0) return 0;
  knn_morton<<<bsz, 1024, 0, static_cast<cudaStream_t>(stream)>>>(points, pmask, np, code);
  return (int)cudaGetLastError();
}

// query (B, n, 3), qmask (B, n), points (B, np, 3), pmask (B, np) (masks
// one byte each, 0 or 1); qorder (B, n), porder (B, np) int64: the order to
// take queries and points in (null: as given), and with porder box scratch
// of (B, ceil(np / 64), 8) floats (the blocks' boxes, for pruning) ->
// dists (B, n, k) ascending (1e10 where empty), idx (B, n, k) int64 (-1
// where empty, and on every column of a masked query), rows and indices as
// given. 1 <= k <= 32; with exclude_self, query i is point i.
extern "C" int knn_forward(const float* query, const unsigned char* qmask, const float* points,
                           const unsigned char* pmask, const long long* qorder,
                           const long long* porder, float* box, int bsz, int n, int np, int k,
                           int exclude_self, float* dists, long long* idx, void* stream) {
  if (bsz < 0 || n < 0 || np < 0 || k < 1 || k > 32 || (porder != nullptr && box == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (porder != nullptr && np > 0) {
    const dim3 grid(((np + kBlock - 1) / kBlock + 7) / 8, bsz);
    knn_boxes<<<grid, 256, 0, s>>>(points, pmask, porder, np, box);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const float* boxes = porder != nullptr ? box : nullptr;
  return k <= 16 ? launch<16>(query, qmask, points, pmask, qorder, porder, boxes, bsz, n, np, k,
                              exclude_self, dists, idx, s)
                 : launch<32>(query, qmask, points, pmask, qorder, porder, boxes, bsz, n, np, k,
                              exclude_self, dists, idx, s);
}
