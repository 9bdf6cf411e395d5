// Fused IGR SDF-MLP: value, or value + input gradient, for N points, in the
// f32 mode (3xTF32) or the bf16 mode, on the tensor cores.
//
// Replaces `_igr_kernel` (isopoints_tpu/ops/pallas_mlp.py:417, reached by
// `make_fused_igr_sdf` :489, pallas_call :535) in both of its modes. A block
// loads its points and runs mlp_mma.cuh's `tile()` on them; see there for
// the layout, the skip and the precision of each mode.
//
// Bound on an H100. One value eval of the 4x256 bench field is 2(3*256 +
// 3*256*256 + 256) ~ 0.40 MFLOP against 16 bytes of point and value (with
// the gradient the three tangent rows make the products ~4x), so operations
// bound it: in bf16 the products over the dense bf16 tensor-core peak
// (989 TFLOP/s), in f32 three tf32 passes over the tf32 peak (495 TFLOP/s).
// Past the products, every activation needs a softplus on the CUDA cores
// (accurate expf, log1pf and an IEEE division, and on value rows of the
// gradient mode the sigmoid's expf and division): 524,288 points x 4 layers
// x 256 is ~0.5 G of them, a floor of roughly 0.5-1.5 ms that is larger
// than the bf16 tensor-core bound (0.21 ms at that size).
// At 8x512 (the published IGR network) one value eval is 2(3*512 + 7*512^2
// + 512) = 3,674,112 FLOP: the bf16 bound at 524,288 points is 1.95 ms and
// the f32 one at 220,202 points 4.90 ms, and the products, not the
// softplus (3.7 G at 524,288 points), are the larger part.
//
// Design. 128 rows per block share each streamed weight chunk, so a
// 524,288-point launch reads the weights 4096 times from L2 instead of
// 8192 at 64 rows; 16 warps per block, each with a 32-row x H/4 tile, so
// that four warps per scheduler hide the epilogue's latency;
// `mma.sync` (m16n8k16 bf16, m16n8k8 tf32) from `ldmatrix` fragments,
// K-major operands in padded shared memory; the weights pre-rounded (bf16)
// or pre-split (tf32 hi/lo) once on the host; the first layer, the head
// and the whole epilogue in f32 on the CUDA cores. `mma.sync`, not
// `wgmma`: the epilogue, not the products, bounds the kernel (see above),
// and `mma.sync` keeps the accumulators in the lanes that own a point's
// four rows. The dynamic shared-memory limit is raised once per template
// instance, not per launch.
//
// Above 256 (the `_wide` library) the products and the weight stream are
// the larger part, and a 32-row `mma.sync` block would stream the 14.7 MB
// f32 stack from L2 for every 32 rows. The wide instances run
// mlp_wide.cuh's tile instead: `wgmma` with A from registers
// and the weights from TMA-fed stages on mbarriers, a producer warp, two
// consumer warpgroups a block, a pair of blocks (a cluster of 2) a 64-row
// tile, each block half of every layer's columns, so 64 rows share each
// read of the stack.
//
// Plain C interface for ctypes; launches on the caller's stream and returns
// cudaGetLastError() after the launch.

#include "mlp_mma.cuh"
#ifdef MLP_MMA_WIDE_LIB
#include "mlp_wide.cuh"
#endif

namespace {

using mlp_mma::Net;

// RG row groups a block (mlp_mma::max_row_groups: 4 up to 256, fewer above)
template <class Mode, int NJ>
constexpr int kRG = mlp_mma::max_row_groups<Mode>(NJ * 32);

template <class Mode, int NJ, int C>
__global__ void __launch_bounds__(128 * kRG<Mode, NJ>, 1)
    igr_points_kernel(Net net, const float* __restrict__ x, int n, float* __restrict__ val,
                      float* __restrict__ grad) {
  constexpr int H = NJ * 32;
  constexpr int RG = kRG<Mode, NJ>;
  constexpr int P = 32 * RG / C;  // points per block
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* act = smem;
  unsigned char* wbuf = act + 32 * RG * mlp_mma::pitch_a<Mode>(H);
  float* xs = reinterpret_cast<float*>(wbuf + 2 * mlp_mma::stage_bytes<Mode>(H));
  const int p0 = blockIdx.x * P;
  for (int e = threadIdx.x; e < P * 3; e += 128 * RG)
    xs[e] = (p0 + e / 3 < n) ? x[(size_t)p0 * 3 + e] : 0.f;
  mlp_mma::tile<Mode, H, C, mlp_mma::IgrAct, RG>(net, xs, act, wbuf, p0, n, val, grad);
}

template <class Mode, int NJ, int C>
int launch(const Net& net, const float* x, int n, float* val, float* grad, cudaStream_t stream) {
  constexpr int H = NJ * 32;
#ifdef MLP_MMA_WIDE_LIB
  return mlp_wide::launch_points<Mode, H, C, mlp_mma::IgrAct>(net, x, n, val, grad, stream);
#else
  constexpr int RG = kRG<Mode, NJ>;
  constexpr int P = 32 * RG / C;
  constexpr int smem = mlp_mma::smem_bytes<Mode, C, RG>(H);
  static_assert(smem <= 232448, "the tile exceeds a block's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      igr_points_kernel<Mode, NJ, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (n + P - 1) / P;
  igr_points_kernel<Mode, NJ, C><<<blocks, 128 * RG, smem, stream>>>(net, x, n, val, grad);
  return (int)cudaGetLastError();
#endif
}

template <class Mode, int C>
int dispatch(const Net& net, int hidden, const float* x, int n, float* val, float* grad,
             cudaStream_t stream) {
  switch (hidden / 32) {
#define CASE(NJ) \
  case NJ: return launch<Mode, NJ, C>(net, x, n, val, grad, stream);
    MLP_MMA_WIDTHS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, 3) -> val (n,) [, grad (n, 3) when grad != nullptr]. w0, b0, bh,
// wout, bout: float32 (in the bf16 mode w0 and wout bf16-rounded); wh: the
// hidden layers (L, H, H) in (out, in) layout, bf16 in the bf16 mode and
// the tf32 hi part (float32) in the f32 mode, with wh_lo the tf32 lo part
// (f32 mode only); in the `_wide` library wh is the wide tile's stage pack
// (ops/fused_mlp.wide_layout, hi and lo together) and wh_lo unused. hidden
// must be an instance's width (mlp_mma::in_library: a multiple of 32 up to
// 256, or 384 or 512 in the `_wide` library; the wrapper pads to it).
extern "C" int igr_forward(const float* x, int n, const float* w0, const float* b0,
                           const void* wh, const void* wh_lo, const float* bh, const float* wout,
                           const float* bout, int hidden, int n_hidden, unsigned skip,
                           int final_tanh, int bf16, float* val, float* grad, void* stream) {
  if (!mlp_mma::in_library(hidden) || n_hidden < 0 || n < 0 || (skip & 1u) ||
      (n_hidden > 0 && (wh == nullptr || (!bf16 && mlp_mma::kLoApart && wh_lo == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Net net{w0, b0, wh, wh_lo, bh, wout, bout, n_hidden, skip, final_tanh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return grad == nullptr ? dispatch<mlp_mma::Bf16Mode, 1>(net, hidden, x, n, val, grad, s)
                           : dispatch<mlp_mma::Bf16Mode, 4>(net, hidden, x, n, val, grad, s);
  return grad == nullptr ? dispatch<mlp_mma::Tf32x3Mode, 1>(net, hidden, x, n, val, grad, s)
                         : dispatch<mlp_mma::Tf32x3Mode, 4>(net, hidden, x, n, val, grad, s);
}
