// Fused SIREN SDF-MLP: value, or value + input gradient, for N points, in
// the f32 mode (3xTF32) or the bf16 mode, on the tensor cores.
//
// Replaces `_siren_kernel` (isopoints_tpu/ops/pallas_mlp.py:250, reached by
// `make_fused_siren_sdf` :309, pallas_call :348) in both of its modes. A
// block loads its points and runs mlp_mma.cuh's `tile()` with the sine
// activation on them; see there for the layout and the precision. f32:
// each operand split into tf32 hi and lo; hi*hi of each k8 step and the
// correction products lo*hi + hi*lo of each k16 chunk summed into zeroed
// tiles and added to the f32 accumulator with IEEE adds. bf16 (the coarse
// phase of the trace, JAX's 'bf16' mode): x, the activations and tangents
// and every layer's weights rounded to bf16 (the weights on the host), one
// m16n8k16 pass per k16 step, each chunk summed into a zeroed tile and
// added in f32. In both modes the first layer, the head, the biases and the
// sine epilogue run in f32 on the CUDA cores with the accurate
// sinf/sincosf (JAX's bf16 mode takes a range-reduced polynomial within
// ~1e-7 of them; the plain version takes torch.sin, as here).
//
// Bound on an H100: the work is operations, not bytes. One value eval of a
// 3x256 SIREN is 2(3*256 + 3*256^2 + 256) ~ 0.40 MFLOP against 16 bytes of
// point and value, so the products bound it: in bf16 one pass over the
// dense bf16 tensor-core peak (989 TFLOP/s), in f32 three tf32 passes over
// the tf32 peak (495 TFLOP/s), the least time f32 products take on the
// card. With the gradient the three tangent rows make it ~4x the
// operations. At 3x512 a value eval is 2(3*512 + 2*512^2 + 512) ~ 1.05
// MFLOP.
//
// Design. What bounds the path's small launches is filling the card: the
// warm-up trace evaluates 4096 points at a time, value only, which 128-row
// tiles cut into 32 blocks for 132 SMs. Each block streams the whole weight
// stack (hi and lo, 1.5 MB at 3x256) from L2 whatever its rows, so large
// launches want many rows a block and small ones many blocks: a launch takes
// 128-row tiles when they give at least half the SMs a block, and 32-row
// tiles below that (above 256 every launch runs mlp_wide.cuh's tile: a
// pair of blocks a 64-row tile, 128 rows a weight read). Measured on an H100 (kernel_variants.py, PERF.md): at
// 4096 value rows (32 blocks of 128) 32-row tiles take 0.141 ms against
// 0.246; at 3000 points with the gradient (12,000 rows, 94 blocks) 128-row
// tiles take 0.183 ms against 0.238; 64-row tiles won at no shape.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "mlp_mma.cuh"
#ifdef MLP_MMA_WIDE_LIB
#include "mlp_wide.cuh"
#endif

namespace {

using mlp_mma::Bf16Mode;
using mlp_mma::Net;
using mlp_mma::SirenAct;
using mlp_mma::Tf32x3Mode;

template <class Mode, int NJ, int C, int RG>
__global__ void __launch_bounds__(128 * RG, 1)
    siren_points_kernel(Net net, const float* __restrict__ x, int n, float* __restrict__ val,
                        float* __restrict__ grad) {
  constexpr int H = NJ * 32;
  constexpr int P = 32 * RG / C;  // points per block
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* act = smem;
  unsigned char* wbuf = act + 32 * RG * mlp_mma::pitch_a<Mode>(H);
  float* xs = reinterpret_cast<float*>(wbuf + 2 * mlp_mma::stage_bytes<Mode>(H));
  const int p0 = blockIdx.x * P;
  for (int e = threadIdx.x; e < P * 3; e += 128 * RG)
    xs[e] = (p0 + e / 3 < n) ? x[(size_t)p0 * 3 + e] : 0.f;
  mlp_mma::tile<Mode, H, C, SirenAct, RG>(net, xs, act, wbuf, p0, n, val, grad);
}

template <class Mode, int NJ, int C, int RG>
int launch(const Net& net, const float* x, int n, float* val, float* grad, cudaStream_t stream) {
  constexpr int H = NJ * 32;
  constexpr int P = 32 * RG / C;
  constexpr int smem = mlp_mma::smem_bytes<Mode, C, RG>(H);
  static_assert(smem <= 232448, "the tile exceeds a block's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      siren_points_kernel<Mode, NJ, C, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (n + P - 1) / P;
  siren_points_kernel<Mode, NJ, C, RG><<<blocks, 128 * RG, smem, stream>>>(net, x, n, val, grad);
  return (int)cudaGetLastError();
}

// row groups a block: 4 (128 rows) when that gives half the SMs a block
int row_groups(int n, int c) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return 2LL * ((long long)n * c + 127) / 128 >= sms ? 4 : 1;
}

// the large tile is the most row groups the width takes (4; above 256 the
// wide tile, mlp_wide.cuh)
template <class Mode, int NJ, int C>
int by_rows(const Net& net, const float* x, int n, float* val, float* grad, cudaStream_t s) {
#ifdef MLP_MMA_WIDE_LIB
  return mlp_wide::launch_points<Mode, NJ * 32, C, SirenAct>(net, x, n, val, grad, s);
#else
  constexpr int kMax = mlp_mma::max_row_groups<Mode>(NJ * 32);
  switch (row_groups(n, C)) {
    case 4: return launch<Mode, NJ, C, kMax>(net, x, n, val, grad, s);
    default: return launch<Mode, NJ, C, 1>(net, x, n, val, grad, s);
  }
#endif
}

template <class Mode, int C>
int dispatch(const Net& net, int hidden, const float* x, int n, float* val, float* grad,
             cudaStream_t stream) {
  switch (hidden / 32) {
#define CASE(NJ) \
  case NJ: return by_rows<Mode, NJ, C>(net, x, n, val, grad, stream);
    MLP_MMA_WIDTHS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, 3) -> val (n,) [, grad (n, 3) when grad != nullptr]. w0 (H, 3), b0,
// bh (L, H), wout (H,), bout (1,): float32 (in the bf16 mode w0 and wout
// bf16-rounded); wh: the hidden layers (L, H, H) in (out, in) layout, bf16
// in the bf16 mode and the tf32 hi part (float32) in the f32 mode, with
// wh_lo the tf32 lo part (f32 mode only); in the `_wide` library wh is the
// wide tile's stage pack and wh_lo unused. hidden must be an instance's width
// (mlp_mma::in_library: a multiple of 32 up to 256, or 384 or 512 in the
// `_wide` library; the wrapper pads to it).
extern "C" int siren_forward(const float* x, int n, const float* w0, const float* b0,
                             const void* wh, const void* wh_lo, const float* bh,
                             const float* wout, const float* bout, int hidden, int n_hidden,
                             float omega_first, float omega_hidden, int bf16, float* val,
                             float* grad, void* stream) {
  if (!mlp_mma::in_library(hidden) || n_hidden < 0 || n < 0 ||
      (n_hidden > 0 && (wh == nullptr || (!bf16 && mlp_mma::kLoApart && wh_lo == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Net net{w0, b0, wh, wh_lo, bh, wout, bout, n_hidden, 0u, 0, omega_first, omega_hidden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return grad == nullptr ? dispatch<Bf16Mode, 1>(net, hidden, x, n, val, grad, s)
                           : dispatch<Bf16Mode, 4>(net, hidden, x, n, val, grad, s);
  return grad == nullptr ? dispatch<Tf32x3Mode, 1>(net, hidden, x, n, val, grad, s)
                         : dispatch<Tf32x3Mode, 4>(net, hidden, x, n, val, grad, s);
}
