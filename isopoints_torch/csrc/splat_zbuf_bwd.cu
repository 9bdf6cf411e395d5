// Splat rasterization, zbuf backward at tile level: per tile, the zbuf
// cotangent of every fragment summed into the fragment's local candidate
// slot (the fine stage's `slots` map), out[t, m] = sum over (pixel, k) with
// slots[t, pixel, k] == m of gz[t, pixel, k]. A slot of -1 never hits.
//
// Replaces `_zbuf_bwd_kernel` (isopoints_tpu/rendering/pallas_splat.py:186,
// reached by `zbuf_backward_tile_pallas` :208, pallas_call :222). Same
// contract as the plain `zbuf_backward_tile_plain` (rendering/splat.py); the
// caller finishes with one (n_tiles * M) -> P scatter over the candidates'
// point ids.
//
// Bound on an H100: bytes, n_tiles * T^2 * K * 8 read (slot and cotangent)
// and n_tiles * M * 4 written.
//
// Design: one block per tile, one thread per candidate slot m. The TPU kernel
// builds a (T^2, M) one-hot per pick; here the tile's T^2 * K (slot,
// cotangent) pairs are staged once in shared memory (10 KB at T = 16, K = 5)
// and every thread walks them all, summing its matches in a fixed
// pixel-then-k order. Every read of a pair is a broadcast from shared memory
// (all threads read the same address), and there are no atomics, so the sums
// are repeatable bit for bit.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

__global__ void zbuf_bwd_kernel(const int* __restrict__ slots, const float* __restrict__ gz,
                                int n_frag, int M, float* __restrict__ out) {
  extern __shared__ int2 s_frag[];  // (n_frag,) {slot, cotangent bits}
  const size_t f0 = (size_t)blockIdx.x * n_frag;
  for (int f = threadIdx.x; f < n_frag; f += blockDim.x)
    s_frag[f] = make_int2(slots[f0 + f], __float_as_int(gz[f0 + f]));
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float acc = 0.f;
    for (int f = 0; f < n_frag; ++f) {
      const int2 e = s_frag[f];
      if (e.x == m) acc = __fadd_rn(acc, __int_as_float(e.y));
    }
    out[(size_t)blockIdx.x * M + m] = acc;
  }
}

}  // namespace

// slots (n_tiles, n_frag) int32 local candidate slots (-1 = empty), gz
// (n_tiles, n_frag) float32 cotangents, n_frag = T*T*K in pixel-then-k order
// -> out (n_tiles, M) float32.
extern "C" int zbuf_backward_tile(const int* slots, const float* gz, int n_tiles, int n_frag,
                                  int M, float* out, void* stream) {
  const size_t smem = sizeof(int2) * (size_t)n_frag;
  if (n_tiles < 0 || n_frag < 1 || M < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(zbuf_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = M >= 1024 ? 1024 : ((M + 31) / 32) * 32;
  zbuf_bwd_kernel<<<n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      slots, gz, n_frag, M, out);
  return (int)cudaGetLastError();
}
