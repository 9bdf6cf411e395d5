// Splat rasterization, fine stage: per T x T tile, score the tile's M
// candidate splats at every pixel (EWA conic, axis-aligned radii, cutoff)
// and keep each pixel's K nearest by depth, with the depth-merging cut.
//
// Replaces `_fine_kernel` (isopoints_tpu/rendering/pallas_splat.py:42,
// reached by `rasterize_fine_pallas` :126, pallas_call :175). Same
// contract as the plain `rasterize_fine_plain` (rendering/splat.py): idx
// (global point ids), zbuf, qvalue and local candidate slots per pixel and
// pick, per-pixel occupancy, per-candidate `used` flags.
//
// Bound on an H100: bytes at the main path's shapes. The least traffic is
// the candidates' ids and flags and their table rows read once and the
// (T^2, K) maps written once (~104 bytes a pixel at K = 5); the scoring,
// ~12 FLOP (two differences, the conic's products and sums, compares) per
// (pixel, candidate) pair a walk must score, is far below it.
//
// Design: one block per tile, one thread per pixel. The TPU kernel selects
// the K minima with K masked-min sweeps over a (T^2, M) score array; a
// K-entry insertion list per pixel over all M slots would still score every
// slot, in no order that lets a pixel stop. Here the block gathers its
// candidates' nine attributes from the (B, P, 9) per-splat table itself (no
// (B, nt^2, M, 9) copy in device memory), and ranks its ok candidates by
// (depth, global id) in shared memory: each thread counts the entries
// before its own (M compares, no barrier inside the loop), and places its
// entry at that rank with its slot in the caller's list beside it. Each
// pixel then walks the candidates in depth order and appends every hit:
// the first hit is the nearest and settles the occupancy, the
// depth-merging cut z - z0 <= depth_merge is monotone in z, so once a pixel
// has a hit it stops at the first candidate, hit or not, that fails the
// cut (no later one could pass it), or at the K-th kept hit; a warp leaves
// the walk when `__all_sync` says every lane is done. The outputs
// equal the plain version's (K masked-min sweeps, ties by the smaller
// global id) for every order of the candidate list. Each warp first tests
// 32 candidates' boxes against its pixels' rectangle with the
// pixels' own rounded differences at its corners (conservative: fl(x - px)
// is monotone in x) and walks only the ballot's survivors
// (`isopoints_torch.kernel_variants` builds copies without the cull and
// without the early exit for the measurements). A pixel's hits
// go to shared memory; the tile's (T^2, K) outputs, which are contiguous,
// are written out by consecutive threads at the end (a pixel's K entries
// written in place would spread each warp store over 32 sectors).
// q = a dx^2 + b dx dy + c dy^2 is formed as the JAX package's XLA code
// forms it, fma(c dy, dy, fma(a dx, dx, (b dx) dy)), so a pixel at the
// cutoff falls the same way in the kernel and in the plain version (which
// uses utils.fma).
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kAttrs = 9;  // px, py, z, ea, eb, ec, rx, ry, cutoff
constexpr unsigned kFull = 0xffffffffu;

// (depth, global id) as one key whose unsigned order is the float order of
// the depth (+0 for -0), then the id
__device__ __forceinline__ unsigned long long order_key(float z, int g) {
  unsigned u = __float_as_uint(z == 0.f ? 0.f : z);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)g;
}

__global__ void fine_kernel(const float* __restrict__ table, const long long* __restrict__ cand,
                            const unsigned char* __restrict__ ok, int P, int n_tiles, int M,
                            int S, int T, int nt, int K, float inv_s, float depth_merge,
                            long long* __restrict__ out_idx,
                            float* __restrict__ out_z, float* __restrict__ out_q,
                            int* __restrict__ out_slot, float* __restrict__ out_occ,
                            unsigned char* __restrict__ out_used) {
  extern __shared__ unsigned long long sm[];
  unsigned long long* c_key = sm;                            // (M,) ok entries, slot order
  float* s_att = reinterpret_cast<float*>(c_key + M);        // (kAttrs, M) by rank
  int* s_gid = reinterpret_cast<int*>(s_att + kAttrs * M);   // (M,) by rank
  int* s_slot = s_gid + M;                                   // (M,) by rank: slot in the list
  int* c_slot = s_slot + M;                                  // (M,) ok entries, slot order
  int* s_used = c_slot + M;                                  // (M,) by slot
  const int TT = T * T;
  int* o_gid = s_used + M;                                   // (T*T, K) the tile's
  int* o_slot = o_gid + TT * K;                              // outputs, written out
  float* o_z = reinterpret_cast<float*>(o_slot + TT * K);    // coalesced at the end
  float* o_q = o_z + TT * K;
  __shared__ int warp_n[32];

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const size_t cand0 = ((size_t)b * n_tiles + tile) * M;
  const float* tab = table + (size_t)b * P * kAttrs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  // 1. the ok entries in slot order, with their (depth, id) keys
  int n_ok = 0;
  for (int m0 = 0; m0 < M; m0 += blockDim.x) {
    const int m = m0 + threadIdx.x;
    const bool o = m < M && ok[cand0 + m];
    unsigned long long key = 0ull;
    if (o) {
      const int g = (int)cand[cand0 + m];
      key = order_key(tab[(size_t)g * kAttrs + 2], g);
    }
    if (m < M) s_used[m] = 0;
    const unsigned bal = __ballot_sync(kFull, o);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int pos = n_ok, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      total += warp_n[w];
      if (w < warp) pos += warp_n[w];
    }
    if (o) {
      pos += __popc(bal & below);
      c_key[pos] = key;
      c_slot[pos] = m;
    }
    n_ok += total;
    __syncthreads();
  }

  // 2. rank by (depth, id, position) and place each at its rank
  for (int i = threadIdx.x; i < n_ok; i += blockDim.x) {
    const unsigned long long key = c_key[i];
    int r = 0;
    for (int j = 0; j < n_ok; ++j) {
      const unsigned long long kj = c_key[j];
      r += (kj < key) | ((kj == key) & (j < i));
    }
    const int g = (int)(key & 0xffffffffull);
    const float* a = tab + (size_t)g * kAttrs;
#pragma unroll
    for (int j = 0; j < kAttrs; ++j) s_att[j * M + r] = a[j];
    s_gid[r] = g;
    s_slot[r] = c_slot[i];
  }
  __syncthreads();

  // 3. each pixel walks the candidates in depth order
  const int lin = threadIdx.x;
  const bool active = lin < TT;
  const int pix = min(lin, TT - 1);  // row-major in the tile; idle lanes take one too
  const int row = (tile / nt) * T + pix / T;
  const int col = (tile % nt) * T + pix % T;
  const float xf = common::pixel_ndc(col, S, inv_s);
  const float yf = common::pixel_ndc(row, S, inv_s);
  const size_t tile0 = ((size_t)b * n_tiles + tile) * TT;
  int nh = 0;
  float z0 = 0.f;
  bool occ = false, done = !active;
  auto visit = [&](int r) {
    const float z = s_att[2 * M + r];
    if (occ && !(__fsub_rn(z, z0) <= depth_merge)) {  // nor any later candidate
      done = true;
      return;
    }
    const float dx = __fsub_rn(xf, s_att[0 * M + r]);
    const float dy = __fsub_rn(yf, s_att[1 * M + r]);
    const float q = __fmaf_rn(__fmul_rn(s_att[5 * M + r], dy), dy,
                              __fmaf_rn(__fmul_rn(s_att[3 * M + r], dx), dx,
                                        __fmul_rn(__fmul_rn(s_att[4 * M + r], dx), dy)));
    if (!(fabsf(dx) <= s_att[6 * M + r] && fabsf(dy) <= s_att[7 * M + r] &&
          q <= s_att[8 * M + r]))
      return;
    if (!occ) {
      occ = true;
      z0 = z;
    }
    if (!(__fsub_rn(z, z0) <= depth_merge)) {  // the first hit, where depth_merge < 0
      done = true;
      return;
    }
    const int o = pix * K + nh;
    o_gid[o] = s_gid[r];
    o_z[o] = z;
    o_q[o] = q;
    o_slot[o] = s_slot[r];
    s_used[s_slot[r]] = 1;
    done = ++nh == K;
  };
  // the warp's pixel rectangle; pixel NDC falls as the index rises
  const float x_hi = common::pixel_ndc(__reduce_min_sync(kFull, col), S, inv_s);
  const float x_lo = common::pixel_ndc(__reduce_max_sync(kFull, col), S, inv_s);
  const float y_hi = common::pixel_ndc(__reduce_min_sync(kFull, row), S, inv_s);
  const float y_lo = common::pixel_ndc(__reduce_max_sync(kFull, row), S, inv_s);
  for (int base = 0; base < n_ok; base += 32) {
    if (__all_sync(kFull, done)) break;
    const int r = base + lane;
    bool near = false;
    if (r < n_ok) {
      const float cx = s_att[0 * M + r], cy = s_att[1 * M + r];
      const float rx = s_att[6 * M + r], ry = s_att[7 * M + r];
      near = __fsub_rn(x_hi, cx) >= -rx && __fsub_rn(x_lo, cx) <= rx &&
             __fsub_rn(y_hi, cy) >= -ry && __fsub_rn(y_lo, cy) <= ry;
    }
    for (unsigned m = __ballot_sync(kFull, near); m; m &= m - 1)
      if (!done) visit(base + __ffs(m) - 1);
  }
  if (active) {
    for (int s = nh; s < K; ++s) {
      const int o = pix * K + s;
      o_gid[o] = -1;
      o_z[o] = -1.f;
      o_q[o] = -1.f;
      o_slot[o] = -1;
    }
    out_occ[tile0 + pix] = occ ? 1.f : 0.f;
  }
  __syncthreads();
  // the tile's (T*T, K) outputs are contiguous: consecutive threads write
  // consecutive words
  const size_t out0 = tile0 * K;
  for (int i = threadIdx.x; i < TT * K; i += blockDim.x) {
    out_idx[out0 + i] = o_gid[i];
    out_z[out0 + i] = o_z[i];
    out_q[out0 + i] = o_q[i];
    out_slot[out0 + i] = o_slot[i];
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) out_used[cand0 + m] = (unsigned char)s_used[m];
}

}  // namespace

// table (B, P, 9) float32 [px, py, z, ea, eb, ec, rx, ry, cutoff] per splat;
// cand (B, n_tiles, M) int64 point ids of each tile's candidates and ok
// (B, n_tiles, M) bool bytes -> idx (B, n_tiles, T*T, K) int64, slots int32,
// zbuf, qv float32, occ (B, n_tiles, T*T) float32, used (B, n_tiles, M)
// bool bytes. inv_s = 1/S rounded to float; T*T <= 1024, K >= 1.
extern "C" int rasterize_fine(const float* table, const long long* cand, const unsigned char* ok,
                              int B, int P, int n_tiles, int M, int S, int T, int nt, int K,
                              float inv_s, float depth_merge, long long* idx, float* zbuf,
                              float* qv, int* slots, float* occ, unsigned char* used,
                              void* stream) {
  if (B < 0 || P < 1 || n_tiles < 0 || M < 1 || T < 1 || T * T > 1024 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_tiles == 0) return 0;
  static int smem_limit = -1;
  const int smem = M * (8 + 4 * (kAttrs + 4)) + T * T * K * 16;
  const cudaError_t err = common::allow_dynamic_smem(fine_kernel, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((T * T + 31) / 32) * 32;
  fine_kernel<<<dim3(n_tiles, B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, cand, ok, P, n_tiles, M, S, T, nt, K, inv_s, depth_merge, idx, zbuf, qv, slots, occ,
      used);
  return (int)cudaGetLastError();
}
