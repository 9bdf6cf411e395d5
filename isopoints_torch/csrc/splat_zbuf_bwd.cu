// Splat rasterization, zbuf backward to the points: per tile, the zbuf
// cotangent of every fragment summed into the fragment's local candidate
// slot (the fine stage's `slots` map), and each slot's sum added to its
// candidate's point, gz[b, cand_idx[b, t, m]] += sum over (pixel, k) of
// tile t with slots[b, t, pixel, k] == m of g_zbuf[b, pixel, k]. A slot of
// -1 never hits, and a slot no fragment hit adds nothing.
//
// Replaces `_zbuf_bwd_kernel` (isopoints_tpu/rendering/pallas_splat.py:186,
// reached by `zbuf_backward_tile_pallas` :208, pallas_call :222) and the
// caller's (n_tiles * M) -> P scatter after it
// (isopoints_tpu/rendering/rasterizer.py:633-643). Same contract as the
// plain `zbuf_backward_points_plain` (rendering/splat.py): the tile sums
// followed by `index_add_`.
//
// Bound on an H100: bytes. Each fragment's slot (int32) and cotangent
// (float32) are read once, each hit slot's point id (int64) once, and the
// (B, P) gradient is written once: ~8 bytes per fragment, a few
// microseconds at 512 px.
//
// Design. One block per (cloud, tile), 8 warps. The cotangent is read in
// image layout (B, S, S, K): the block computes its tile's pixel offsets,
// so no tiled copy is made. The tile's T^2 * K fragments go in batches of
// 32, batch i to warp i % 8, in pixel-then-k order. In a batch,
// `__match_any_sync` groups the lanes of equal slots; the group's lowest
// lane sums the group's cotangents in lane order and adds the sum to its
// warp's row of per-slot partial sums in shared memory. Then thread m adds
// the eight warps' partials of slot m in warp order: O(T^2 K + 8 M) work
// per tile in a fixed order, so the tile sums repeat bit for bit. A slot
// that some fragment hit adds its sum to its point with one `atomicAdd`,
// the same order-free sum `index_add_` makes; the empty slots (which the
// selection pads with candidate 0) add nothing. `tile_sums`, when not null,
// receives every tile's (M,) sums, `_zbuf_bwd_kernel`'s output. Shared
// memory stays within the default 48 KB for M <= 1336, so no attribute is
// set.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t smem_bytes(int M) {
  return sizeof(float) * ((size_t)kWarps * M + M + kWarps * 32);
}

__global__ void __launch_bounds__(kThreads)
    zbuf_points_kernel(const int* __restrict__ slots, const float* __restrict__ g_zbuf,
                       const long long* __restrict__ cand, int S, int T, int K, int M, int P,
                       float* __restrict__ gz, float* __restrict__ tile_sums) {
  extern __shared__ float smem[];
  float* part = smem;                                        // (kWarps, M)
  int* hit = reinterpret_cast<int*>(part + kWarps * M);      // (M,)
  float* vals = reinterpret_cast<float*>(hit + M);           // (kWarps, 32)
  const int nt = S / T;
  const int bt = blockIdx.x;  // b * nt^2 + tile
  const int b = bt / (nt * nt), tile = bt - b * nt * nt;
  const int y0 = (tile / nt) * T, x0 = (tile % nt) * T;
  const int n_frag = T * T * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kWarps * M; i += kThreads) part[i] = 0.f;
  for (int i = threadIdx.x; i < M; i += kThreads) hit[i] = 0;
  __syncthreads();

  const int* sl = slots + (size_t)bt * n_frag;
  const float* img = g_zbuf + (size_t)b * S * S * K;
  float* mine = part + warp * M;
  float* vw = vals + warp * 32;
  for (int base = warp * 32; base < n_frag; base += kThreads) {
    const int f = base + lane;
    int s = -1;
    float v = 0.f;
    if (f < n_frag) {
      s = sl[f];
      const int pix = f / K, k = f - pix * K;
      const int py = pix / T, px = pix - py * T;
      v = img[((size_t)(y0 + py) * S + x0 + px) * K + k];
    }
    vw[lane] = v;
    __syncwarp();
    const unsigned grp = __match_any_sync(0xffffffffu, s);
    if (s >= 0 && lane == __ffs(grp) - 1) {
      float acc = 0.f;
      for (unsigned m = grp; m != 0u; m &= m - 1u) acc = __fadd_rn(acc, vw[__ffs(m) - 1]);
      mine[s] = __fadd_rn(mine[s], acc);
      hit[s] = 1;
    }
    __syncwarp();
  }
  __syncthreads();

  for (int m = threadIdx.x; m < M; m += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, part[w * M + m]);
    if (tile_sums != nullptr) tile_sums[(size_t)bt * M + m] = acc;
    if (hit[m]) atomicAdd(gz + (size_t)b * P + cand[(size_t)bt * M + m], acc);
  }
}

}  // namespace

// slots (B, (S/T)^2, T*T, K) int32 local candidate slots (-1 = empty), in
// pixel-then-k order within a tile; g_zbuf (B, S, S, K) float32 cotangents
// in image layout; cand (B, (S/T)^2, M) int64 point ids of the slots; gz
// (B, P) float32, zeroed by the caller, receives the sums; tile_sums
// (B * (S/T)^2, M) float32 or null.
extern "C" int zbuf_backward_points(const int* slots, const float* g_zbuf, const long long* cand,
                                    int B, int S, int T, int K, int M, int P, float* gz,
                                    float* tile_sums, void* stream) {
  if (B < 0 || T < 1 || S % T != 0 || K < 1 || M < 1 || P < 1 || smem_bytes(M) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int nt = S / T;
  if (B == 0 || nt == 0) return 0;
  zbuf_points_kernel<<<B * nt * nt, kThreads, smem_bytes(M), static_cast<cudaStream_t>(stream)>>>(
      slots, g_zbuf, cand, S, T, K, M, P, gz, tile_sums);
  return (int)cudaGetLastError();
}
