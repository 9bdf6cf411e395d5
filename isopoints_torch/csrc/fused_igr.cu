// Fused IGR SDF-MLP: value, or value + input gradient, for N points, in
// f32 or in the bf16 mode.
//
// Replaces `_igr_kernel` (isopoints_tpu/ops/pallas_mlp.py:417, reached by
// `make_fused_igr_sdf` :489, pallas_call :535). The per-tile MLP lives in
// igr.cuh; see there for the layout, the skip and the precision choices.
//
// Bound on an H100: operations. One value eval of the 4x256 bench field is
// 2(3*256 + 3*256*256 + 256) ~ 0.40 MFLOP against 16 bytes of point and
// value; with the gradient the three tangent rows make it ~4x. The f32 mode
// is bound by the f32 CUDA-core peak (67 TFLOP/s). The bf16 mode does the
// same FMAs on rounded operands, so it runs at that rate too, while its
// bound is the dense bf16 tensor-core peak (~990 TFLOP/s): tensor cores are
// left for a later change.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "igr.cuh"

namespace {

using igr::kChunk;
using igr::kRows;
using igr::kThreads;
using igr::Net;

template <int NJ, int C>
__global__ void __launch_bounds__(kThreads)
    igr_points_kernel(Net net, const float* __restrict__ x, int n, float* __restrict__ val,
                      float* __restrict__ grad) {
  constexpr int H = NJ * 32;
  constexpr int P = kRows / C;  // points per tile
  extern __shared__ float smem[];
  float* act = smem;
  float* wbuf = act + kRows * H;
  float* xs = wbuf + kChunk * H;
  float* vs = xs + P * 3;
  float* gs = vs + P;

  const int p0 = blockIdx.x * P;
  for (int e = threadIdx.x; e < P * 3; e += kThreads)
    xs[e] = (p0 + e / 3 < n) ? x[(size_t)p0 * 3 + e] : 0.f;
  __syncthreads();

  igr::tile<NJ, C>(net, xs, act, wbuf, vs, gs);

  for (int e = threadIdx.x; e < P; e += kThreads)
    if (p0 + e < n) val[p0 + e] = vs[e];
  if constexpr (C == 4) {
    for (int e = threadIdx.x; e < P * 3; e += kThreads)
      if (p0 + e / 3 < n) grad[(size_t)p0 * 3 + e] = gs[e];
  }
}

template <int NJ, int C>
int launch(const Net& net, const float* x, int n, float* val, float* grad, cudaStream_t stream) {
  constexpr int H = NJ * 32;
  constexpr int P = kRows / C;
  const size_t smem = sizeof(float) * (igr::tile_smem_floats(H) + P * 3 + P + P * 3);
  cudaError_t err = cudaFuncSetAttribute(igr_points_kernel<NJ, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + P - 1) / P;
  igr_points_kernel<NJ, C><<<blocks, kThreads, smem, stream>>>(net, x, n, val, grad);
  return (int)cudaGetLastError();
}

template <int C>
int dispatch(const Net& net, int hidden, const float* x, int n, float* val, float* grad,
             cudaStream_t stream) {
  switch (hidden / 32) {
#define CASE(NJ) \
  case NJ: return launch<NJ, C>(net, x, n, val, grad, stream);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, 3) -> val (n,) [, grad (n, 3) when grad != nullptr]. The weights
// are the f32 or the bf16-rounded pack, as `bf16` says; hidden must be a
// multiple of 32 in [32, 256] (the wrapper checks it).
extern "C" int igr_forward(const float* x, int n, const float* w0, const float* b0,
                           const float* wh_t, const float* bh, const float* wout,
                           const float* bout, int hidden, int n_hidden, unsigned skip,
                           int final_tanh, int bf16, float* val, float* grad, void* stream) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 256 || n_hidden < 0 || n < 0 || (skip & 1u))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Net net{w0, b0, wh_t, bh, wout, bout, n_hidden, skip, final_tanh, bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return grad == nullptr ? dispatch<1>(net, hidden, x, n, val, grad, s)
                         : dispatch<4>(net, hidden, x, n, val, grad, s);
}
