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
// Bound on an H100: operations at the main path's shapes. Every pixel
// scores every candidate of its tile: ~12 FLOP (two differences, the
// conic's five products and sums, compares) per (pixel, candidate), i.e.
// S^2 * M * 12 FLOP a cloud, against 44 bytes a candidate slot read and
// ~80 bytes a pixel written.
//
// Design: one block per tile, one thread per pixel. The TPU kernel
// selects the K minima with K masked-min sweeps over a (T^2, M) score
// array; here the tile's M candidates (nine attributes, ok flag, global id)
// are staged in shared memory (11 words each: 11 KB at M = 256) and every
// thread keeps a K-entry insertion list in registers, ordered by (depth,
// global point index). That tie-break makes the maps independent of the
// order of the candidate list (the TPU relies on slot order == index
// order instead). q = a dx^2 + b dx dy + c dy^2 is formed as the JAX
// package's XLA code forms it, fma(c dy, dy, fma(a dx, dx, (b dx) dy)), so a
// pixel at the cutoff falls the same way in the kernel and in the plain
// version (which uses utils.fma).
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kAttrs = 9;  // px, py, z, ea, eb, ec, rx, ry, cutoff

template <int K>
__global__ void fine_kernel(const float* __restrict__ attrs, const unsigned char* __restrict__ ok,
                            const int* __restrict__ gid, int n_tiles, int M, int S, int T,
                            int nt, float inv_s, float depth_merge, int* __restrict__ out_idx,
                            float* __restrict__ out_z, float* __restrict__ out_q,
                            int* __restrict__ out_slot, float* __restrict__ out_occ,
                            unsigned char* __restrict__ out_used) {
  extern __shared__ float sm[];
  float* s_att = sm;                                      // (kAttrs, M)
  int* s_gid = reinterpret_cast<int*>(s_att + kAttrs * M);  // (M,), -1 = not ok
  int* s_used = s_gid + M;                                // (M,)

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const size_t cand0 = ((size_t)b * n_tiles + tile) * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float* a = attrs + (cand0 + m) * kAttrs;
#pragma unroll
    for (int j = 0; j < kAttrs; ++j) s_att[j * M + m] = a[j];
    s_gid[m] = ok[cand0 + m] ? gid[cand0 + m] : -1;
    s_used[m] = 0;
  }
  __syncthreads();

  const int lin = threadIdx.x;
  const int TT = T * T;
  if (lin < TT) {
    const int row = (tile / nt) * T + lin / T;
    const int col = (tile % nt) * T + lin % T;
    const float xf = common::pixel_ndc(col, S, inv_s);
    const float yf = common::pixel_ndc(row, S, inv_s);
    float bz[K], bq[K];
    int bg[K], bs[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bz[s] = 0.f;
      bq[s] = 0.f;
      bg[s] = -1;
      bs[s] = -1;
    }
    bool occ = false;
    for (int m = 0; m < M; ++m) {
      const int g = s_gid[m];
      if (g < 0) continue;
      const float dx = __fsub_rn(xf, s_att[0 * M + m]);
      const float dy = __fsub_rn(yf, s_att[1 * M + m]);
      const float q = __fmaf_rn(__fmul_rn(s_att[5 * M + m], dy), dy,
                                __fmaf_rn(__fmul_rn(s_att[3 * M + m], dx), dx,
                                          __fmul_rn(__fmul_rn(s_att[4 * M + m], dx), dy)));
      if (!(fabsf(dx) <= s_att[6 * M + m] && fabsf(dy) <= s_att[7 * M + m] &&
            q <= s_att[8 * M + m]))
        continue;
      occ = true;
      float cz = s_att[2 * M + m], cq = q;
      int cg = g, cs = m;
      // insertion by (depth, global id); an empty entry (bs < 0) sorts last
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (bs[s] < 0 || cz < bz[s] || (cz == bz[s] && cg < bg[s])) {
          const float tz = bz[s], tq = bq[s];
          const int tg = bg[s], ts = bs[s];
          bz[s] = cz;
          bq[s] = cq;
          bg[s] = cg;
          bs[s] = cs;
          cz = tz;
          cq = tq;
          cg = tg;
          cs = ts;
          if (cs < 0) break;
        }
      }
    }
    const size_t pix = ((size_t)b * n_tiles + tile) * TT + lin;
    const float z0 = bz[0];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool keep = bs[s] >= 0 && __fsub_rn(bz[s], z0) <= depth_merge;
      out_idx[pix * K + s] = keep ? bg[s] : -1;
      out_z[pix * K + s] = keep ? bz[s] : -1.f;
      out_q[pix * K + s] = keep ? bq[s] : -1.f;
      out_slot[pix * K + s] = keep ? bs[s] : -1;
      if (keep) s_used[bs[s]] = 1;
    }
    out_occ[pix] = occ ? 1.f : 0.f;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) out_used[cand0 + m] = (unsigned char)s_used[m];
}

template <int K>
int launch(const float* attrs, const unsigned char* ok, const int* gid, int B, int n_tiles,
           int M, int S, int T, int nt, float inv_s, float depth_merge, int* idx, float* zbuf, float* qv,
           int* slots, float* occ, unsigned char* used, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)M * (kAttrs + 2);
  cudaError_t err = cudaFuncSetAttribute(fine_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((T * T + 31) / 32) * 32;
  const dim3 grid(n_tiles, B);
  fine_kernel<K><<<grid, threads, smem, s>>>(attrs, ok, gid, n_tiles, M, S, T, nt, inv_s,
                                             depth_merge, idx, zbuf, qv, slots, occ, used);
  return (int)cudaGetLastError();
}

}  // namespace

// attrs (B, n_tiles, M, 9) float32 [px, py, z, ea, eb, ec, rx, ry, cutoff] of
// each tile's candidates, ok (B, n_tiles, M) uint8, gid (B, n_tiles, M) int32
// global ids -> idx, slots (B, n_tiles, T*T, K) int32, zbuf, qv (B, n_tiles,
// T*T, K) float32, occ (B, n_tiles, T*T) float32, used (B, n_tiles, M) uint8.
// inv_s = 1/S rounded to float; T*T <= 1024, 1 <= K <= 8.
extern "C" int rasterize_fine(const float* attrs, const unsigned char* ok, const int* gid, int B,
                              int n_tiles, int M, int S, int T, int nt, int K, float inv_s,
                              float depth_merge, int* idx, float* zbuf, float* qv, int* slots,
                              float* occ, unsigned char* used, void* stream) {
  if (B < 0 || n_tiles < 0 || M < 1 || T < 1 || T * T > 1024 || K < 1 || K > 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define FINE_CASE(KK) \
  case KK:            \
    return launch<KK>(attrs, ok, gid, B, n_tiles, M, S, T, nt, inv_s, depth_merge, idx, zbuf, \
                      qv, slots, occ, used, s);
    FINE_CASE(1) FINE_CASE(2) FINE_CASE(3) FINE_CASE(4) FINE_CASE(5) FINE_CASE(6)
    FINE_CASE(7) FINE_CASE(8)
#undef FINE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
