// Fused SIREN SDF-MLP: value, or value + input gradient, for N points.
//
// Replaces `_siren_kernel` (isopoints_tpu/ops/pallas_mlp.py:250, reached by
// `make_fused_siren_sdf` :309, pallas_call :348). The per-tile MLP lives in
// siren.cuh; see there for the layout and the precision choices.
//
// Bound on an H100: the work is operations, not bytes. One value eval of a
// 3x256 SIREN is 2(3*256 + 3*256^2 + 256) ~ 0.40 MFLOP against 16 bytes of
// point and value, so the f32 CUDA-core peak (67 TFLOP/s) bounds it; with
// the gradient the three tangent rows make it ~4x the operations. The design
// keeps every activation in shared memory and reads each weight chunk once
// per 64-row tile, so device memory traffic is the points, the outputs and
// the (L2-resident) weights.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "siren.cuh"

namespace {

using siren::kChunk;
using siren::kRows;
using siren::kThreads;
using siren::Net;

template <int NJ, int C>
__global__ void __launch_bounds__(kThreads)
    siren_points_kernel(Net net, const float* __restrict__ x, int n,
                        float* __restrict__ val, float* __restrict__ grad) {
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

  siren::tile<NJ, C>(net, xs, act, wbuf, vs, gs);

  for (int e = threadIdx.x; e < P; e += kThreads)
    if (p0 + e < n) val[p0 + e] = vs[e];
  if constexpr (C == 4) {
    for (int e = threadIdx.x; e < P * 3; e += kThreads)
      if (p0 + e / 3 < n) grad[(size_t)p0 * 3 + e] = gs[e];
  }
}

template <int NJ, int C>
int launch(const Net& net, const float* x, int n, float* val, float* grad,
           cudaStream_t stream) {
  constexpr int H = NJ * 32;
  constexpr int P = kRows / C;
  const size_t smem = sizeof(float) * (siren::tile_smem_floats(H) + P * 3 + P + P * 3);
  cudaError_t err = cudaFuncSetAttribute(
      siren_points_kernel<NJ, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + P - 1) / P;
  siren_points_kernel<NJ, C><<<blocks, kThreads, smem, stream>>>(net, x, n, val, grad);
  return (int)cudaGetLastError();
}

template <int C>
int dispatch(const Net& net, int hidden, const float* x, int n, float* val,
             float* grad, cudaStream_t stream) {
  switch (hidden / 32) {
    case 1: return launch<1, C>(net, x, n, val, grad, stream);
    case 2: return launch<2, C>(net, x, n, val, grad, stream);
    case 3: return launch<3, C>(net, x, n, val, grad, stream);
    case 4: return launch<4, C>(net, x, n, val, grad, stream);
    case 5: return launch<5, C>(net, x, n, val, grad, stream);
    case 6: return launch<6, C>(net, x, n, val, grad, stream);
    case 7: return launch<7, C>(net, x, n, val, grad, stream);
    case 8: return launch<8, C>(net, x, n, val, grad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, 3) -> val (n,) [, grad (n, 3) when grad != nullptr].
// hidden must be a multiple of 32 in [32, 256]; the wrapper checks it.
extern "C" int siren_forward(const float* x, int n, const float* w0, const float* b0,
                             const float* wh_t, const float* bh, const float* wout,
                             const float* bout, int hidden, int n_hidden,
                             float omega_first, float omega_hidden, float* val,
                             float* grad, void* stream) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 256 || n_hidden < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Net net{w0, b0, wh_t, bh, wout, bout, n_hidden, omega_first, omega_hidden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return grad == nullptr ? dispatch<1>(net, hidden, x, n, val, grad, s)
                         : dispatch<4>(net, hidden, x, n, val, grad, s);
}
