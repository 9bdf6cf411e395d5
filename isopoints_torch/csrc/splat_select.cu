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
// Design: one block per strip (tile row) and cloud, 256 threads. The
// TPU's integer bisection, triangular-matmul prefix sums and one-hot
// extraction dots are MXU workarounds; here the capacity threshold is the
// k-th smallest depth found by a 4-round 8-bit radix select on the depth
// bits (non-negative floats order as their bit patterns), skipped when
// the count fits the capacity, and compaction is a block prefix scan in
// index order. The strip's list (up to R entries: x, x-radius, depth bits,
// index) stays in shared memory for the tile phase, which then runs the
// same count / select / scan for each of the strip's nt tiles.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;  // threshold meaning "take every overlap"

// depth bits that order as the depth does (z >= 0; -0 maps to +0)
__device__ __forceinline__ unsigned depth_key(float z) { return __float_as_uint(z) & 0x7fffffffu; }

// Count of `pred(e)` over e in [0, n), block-wide.
template <class Pred>
__device__ int block_count(Pred pred, int n, int* warp_sums) {
  int c = 0;
  for (int e = threadIdx.x; e < n; e += blockDim.x) c += pred(e) ? 1 : 0;
  int total;
  common::block_exclusive_scan(c, warp_sums, total);
  return total;
}

// Keep every e with pred(e) and key < v, plus the first n_tie ones (in
// index order) with key == v; emit(e, slot) gets consecutive slots in
// index order. Every thread of the block calls it.
template <class Pred, class Key, class Emit>
__device__ void block_compact(Pred pred, Key key_of, int n, unsigned v, int n_tie, Emit emit,
                              int* warp_sums) {
  int tie_base = 0, slot_base = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const bool ok = e < n && pred(e);
    const unsigned key = ok ? key_of(e) : 0u;
    const bool strict = ok && key < v;
    const bool tie = ok && key == v;
    int n_ties;
    const int tie_rank = tie_base + common::block_exclusive_scan(tie ? 1 : 0, warp_sums, n_ties);
    const bool taken = strict || (tie && tie_rank < n_tie);
    int n_taken;
    const int slot = slot_base + common::block_exclusive_scan(taken ? 1 : 0, warp_sums, n_taken);
    if (taken) emit(e, slot);
    tie_base += n_ties;
    slot_base += n_taken;
  }
}

// Threshold for keeping k of the `count` elements with pred(e): kAll when
// they all fit, else the k-th smallest key.
template <class Pred, class Key>
__device__ unsigned capacity_threshold(Pred pred, Key key_of, int n, int count, int k, int* hist,
                                       int* bcast) {
  if (count <= k) return kAll;
  auto keyed = [&](int e, unsigned& key) {
    if (!pred(e)) return false;
    key = key_of(e);
    return true;
  };
  return common::block_radix_select(keyed, n, k, hist, bcast);
}

__global__ void __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ z, const float* __restrict__ rx,
                  const float* __restrict__ ry, const unsigned char* __restrict__ valid, int P,
                  int S, int T, int nt, int R, int M, float inv_s, float half,
                  int* __restrict__ cidx,
                  unsigned char* __restrict__ cok, int* __restrict__ ovf) {
  extern __shared__ unsigned char smem[];
  float* s_px = reinterpret_cast<float*>(smem);
  float* s_rx = s_px + R;
  unsigned* s_key = reinterpret_cast<unsigned*>(s_rx + R);
  int* s_idx = reinterpret_cast<int*>(s_key + R);
  __shared__ int warp_sums[32];
  __shared__ int hist[256];
  __shared__ int bcast[2];

  const int g = blockIdx.x;  // strip = tile row
  const int b = blockIdx.y;
  const size_t off = (size_t)b * P;
  px += off;
  py += off;
  z += off;
  rx += off;
  ry += off;
  valid += off;
  const float cy =
      0.5f * (common::pixel_ndc(g * T, S, inv_s) + common::pixel_ndc(g * T + T - 1, S, inv_s));

  // ---- strip phase: the R front-most splats overlapping the tile row
  auto in_strip = [&](int i) { return valid[i] != 0 && fabsf(py[i] - cy) <= ry[i] + half; };
  auto zkey = [&](int i) { return depth_key(z[i]); };
  const int count_s = block_count(in_strip, P, warp_sums);
  const int k_s = min(R, count_s);
  const unsigned v_s = capacity_threshold(in_strip, zkey, P, count_s, k_s, hist, bcast);
  const int strict_s = v_s == kAll ? count_s
                                   : block_count([&](int i) { return in_strip(i) && zkey(i) < v_s; },
                                                 P, warp_sums);
  block_compact(
      in_strip, zkey, P, v_s, k_s - strict_s,
      [&](int i, int slot) {
        s_px[slot] = px[i];
        s_rx[slot] = rx[i];
        s_key[slot] = zkey(i);
        s_idx[slot] = i;
      },
      warp_sums);
  __syncthreads();

  // ---- tile phase on the strip's list, one tile at a time
  int ovf_tiles = 0;
  for (int tj = 0; tj < nt; ++tj) {
    const float cx =
        0.5f * (common::pixel_ndc(tj * T, S, inv_s) +
                common::pixel_ndc(tj * T + T - 1, S, inv_s));
    auto in_tile = [&](int e) { return fabsf(s_px[e] - cx) <= s_rx[e] + half; };
    auto skey = [&](int e) { return s_key[e]; };
    const int count_t = block_count(in_tile, k_s, warp_sums);
    const int k_t = min(M, count_t);
    const unsigned v_t = capacity_threshold(in_tile, skey, k_s, count_t, k_t, hist, bcast);
    const int strict_t = v_t == kAll ? count_t
                                     : block_count([&](int e) { return in_tile(e) && s_key[e] < v_t; },
                                                   k_s, warp_sums);
    const size_t row = (((size_t)b * nt + g) * nt + tj) * M;
    block_compact(
        in_tile, skey, k_s, v_t, k_t - strict_t,
        [&](int e, int slot) {
          cidx[row + slot] = s_idx[e];
          cok[row + slot] = 1;
        },
        warp_sums);
    for (int m = k_t + threadIdx.x; m < M; m += blockDim.x) {
      cidx[row + m] = 0;
      cok[row + m] = 0;
    }
    ovf_tiles += max(count_t - M, 0);
    __syncthreads();
  }
  if (threadIdx.x == 0) ovf[(size_t)b * nt + g] = max(count_s - R, 0) + ovf_tiles;
}

}  // namespace

// Per cloud b of B: px, py, z, rx, ry (B, P) float32, valid (B, P) uint8
// (must already include z >= 0). S image size (inv_s = 1/S rounded to
// float), T tile size, nt = S / T, half = (T - 1)/S,
// R strip capacity (<= P), M tile capacity (<= R). Outputs cidx (B, nt, nt, M)
// int32 point indices, cok (B, nt, nt, M) uint8, ovf (B, nt) int32 per strip.
extern "C" int select_candidates(const float* px, const float* py, const float* z,
                                 const float* rx, const float* ry, const unsigned char* valid,
                                 int B, int P, int S, int T, int nt, int R, int M, float inv_s,
                                 float half, int* cidx, unsigned char* cok, int* ovf,
                                 void* stream) {
  if (B < 0 || P < 1 || T < 1 || nt < 1 || R < 1 || M < 1 || M > R || R > P)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)R * 16;
  cudaError_t err = cudaFuncSetAttribute(select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nt, B);
  select_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      px, py, z, rx, ry, valid, P, S, T, nt, R, M, inv_s, half, cidx, cok, ovf);
  return (int)cudaGetLastError();
}
