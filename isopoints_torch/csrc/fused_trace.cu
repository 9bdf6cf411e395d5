// In-kernel sphere-trace march: a fixed number of fused-backstep iterations
// of both ray fronts against the IGR MLP, the per-ray state in registers.
//
// Replaces `_march_kernel` (isopoints_tpu/ops/pallas_trace.py:43, reached by
// `make_trace_stepper` :103, pallas_call :150) for the IGR field. Per
// iteration and ray (`body_fused`, isopoints_tpu/models/raytracing.py:555):
//   fwd   = un & bk == 0 & sdf > thr ? sdf : 0
//   move  = bk > 0 ? -(ls * 2^-(bk - 1)) * cur : fwd      (ls = 1 - line_search_step)
//   acc_s += move_s, acc_e -= move_e, both fronts evaluated once,
//   may   = un & new < 0 & bk < line_step_iters,
//   cur   = may & bk == 0 ? fwd : cur, bk = may ? bk + 1 : 0,
//   un    = un & (bk > 0 | (new > thr & acc_s < acc_e)), and with the end
//   front gated, un_e &= un_s | bk_e > 0.
// A finished ray (un = 0 implies bk = 0) takes zero moves, so a fixed count
// equals the while loop, and no host synchronisation is needed.
//
// Design. A block takes 32 rays. Threads 0..31 keep their ray's 10 state
// scalars in registers for all iterations; every iteration they write the
// two front points (cam + acc * dir, one __fmaf_rn per coordinate, as the
// PyTorch loop forms them with utils.fma) as rows r and 32 + r of one 64-row
// tile, the whole block evaluates the tile (igr.cuh), and the 32
// threads update the state. Each update is a separate IEEE operation
// (__fadd_rn/__fmul_rn) so that no contraction into an FMA changes it: the
// march equals the PyTorch loop over the fused IGR kernel bit for bit, since
// both evaluate a point with the same per-row arithmetic.
//
// Bound on an H100: operations, 2 * n_iters IGR evals per ray (~0.40 MFLOP
// each at 4x256) against the f32 CUDA-core peak; the bytes moved are 24 of
// rays plus 2 * 34 of state per ray.

#include <stdint.h>

#include "igr.cuh"

namespace {

using igr::kChunk;
using igr::kRows;
using igr::kThreads;
using igr::Net;

constexpr int kRaysPerBlock = kRows / 2;

struct State {
  float* acc_s;
  float* acc_e;
  float* sdf_s;
  float* sdf_e;
  uint8_t* un_s;
  uint8_t* un_e;
  int32_t* bk_s;
  int32_t* bk_e;
  float* cur_s;
  float* cur_e;
};

template <int NJ>
__global__ void __launch_bounds__(kThreads)
    march_kernel(Net net, const float* __restrict__ cam, const float* __restrict__ dir, State st,
                 int n, int n_iters, float thr, float ls, int line_step_iters, int gate_end) {
  constexpr int H = NJ * 32;
  extern __shared__ float smem[];
  float* act = smem;
  float* wbuf = act + kRows * H;
  float* xs = wbuf + kChunk * H;  // (kRows, 3)
  float* vs = xs + kRows * 3;     // (kRows,)

  const int r = threadIdx.x;
  const int g = blockIdx.x * kRaysPerBlock + r;
  const bool mine = r < kRaysPerBlock && g < n;
  float c[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  float acc_s = 0.f, acc_e = 0.f, sdf_s = 0.f, sdf_e = 0.f, cur_s = 0.f, cur_e = 0.f;
  bool un_s = false, un_e = false;
  int bk_s = 0, bk_e = 0;
  if (mine) {
    for (int k = 0; k < 3; ++k) {
      c[k] = cam[(size_t)g * 3 + k];
      d[k] = dir[(size_t)g * 3 + k];
    }
    acc_s = st.acc_s[g];
    acc_e = st.acc_e[g];
    sdf_s = st.sdf_s[g];
    sdf_e = st.sdf_e[g];
    un_s = st.un_s[g] != 0;
    un_e = st.un_e[g] != 0;
    bk_s = st.bk_s[g];
    bk_e = st.bk_e[g];
    cur_s = st.cur_s[g];
    cur_e = st.cur_e[g];
  }

  for (int it = 0; it < n_iters; ++it) {
    float fwd_s = 0.f, fwd_e = 0.f;
    if (r < kRaysPerBlock) {
      fwd_s = (un_s && bk_s == 0 && sdf_s > thr) ? sdf_s : 0.f;
      fwd_e = (un_e && bk_e == 0 && sdf_e > thr) ? sdf_e : 0.f;
      const float scale_s = ldexpf(ls, 1 - bk_s);  // ls * 2^-(bk - 1), exact
      const float scale_e = ldexpf(ls, 1 - bk_e);
      const float move_s = bk_s > 0 ? __fmul_rn(-scale_s, cur_s) : fwd_s;
      const float move_e = bk_e > 0 ? __fmul_rn(-scale_e, cur_e) : fwd_e;
      acc_s = __fadd_rn(acc_s, move_s);
      acc_e = __fsub_rn(acc_e, move_e);
      for (int k = 0; k < 3; ++k) {
        xs[r * 3 + k] = __fmaf_rn(acc_s, d[k], c[k]);
        xs[(kRaysPerBlock + r) * 3 + k] = __fmaf_rn(acc_e, d[k], c[k]);
      }
    }
    __syncthreads();
    igr::tile<NJ, 1>(net, xs, act, wbuf, vs, nullptr);
    if (r < kRaysPerBlock) {
      const float new_s = vs[r], new_e = vs[kRaysPerBlock + r];
      const bool may_s = un_s && new_s < 0.f && bk_s < line_step_iters;
      const bool may_e = un_e && new_e < 0.f && bk_e < line_step_iters;
      if (may_s && bk_s == 0) cur_s = fwd_s;
      if (may_e && bk_e == 0) cur_e = fwd_e;
      bk_s = may_s ? bk_s + 1 : 0;
      bk_e = may_e ? bk_e + 1 : 0;
      const bool not_crossed = acc_s < acc_e;
      un_s = un_s && (bk_s > 0 || (new_s > thr && not_crossed));
      un_e = un_e && (bk_e > 0 || (new_e > thr && not_crossed));
      if (gate_end) un_e = un_e && (un_s || bk_e > 0);
      sdf_s = new_s;
      sdf_e = new_e;
    }
    // the next iteration's writes to xs wait for this one's reads of vs:
    // tile() ends with a barrier after its last read of xs, and vs is only
    // written by the next tile() after the barrier below
    __syncthreads();
  }

  if (mine) {
    st.acc_s[g] = acc_s;
    st.acc_e[g] = acc_e;
    st.sdf_s[g] = sdf_s;
    st.sdf_e[g] = sdf_e;
    st.un_s[g] = un_s ? 1 : 0;
    st.un_e[g] = un_e ? 1 : 0;
    st.bk_s[g] = bk_s;
    st.bk_e[g] = bk_e;
    st.cur_s[g] = cur_s;
    st.cur_e[g] = cur_e;
  }
}

template <int NJ>
int launch(const Net& net, const float* cam, const float* dir, const State& st, int n,
           int n_iters, float thr, float ls, int line_step_iters, int gate_end,
           cudaStream_t stream) {
  constexpr int H = NJ * 32;
  const size_t smem = sizeof(float) * (igr::tile_smem_floats(H) + kRows * 3 + kRows);
  cudaError_t err = cudaFuncSetAttribute(march_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  march_kernel<NJ><<<blocks, kThreads, smem, stream>>>(net, cam, dir, st, n, n_iters, thr, ls,
                                                       line_step_iters, gate_end);
  return (int)cudaGetLastError();
}

}  // namespace

// cam, dir (n, 3); the ten state arrays (n,) are updated in place: acc_s,
// acc_e, sdf_s, sdf_e, cur_s, cur_e float32, un_s, un_e uint8 (0/1), bk_s,
// bk_e int32. `ls` is 1 - line_search_step. The net is the IGR pack of the
// callable's precision (`bf16`).
extern "C" int trace_march_igr(const float* cam, const float* dir, float* acc_s, float* acc_e,
                               float* sdf_s, float* sdf_e, uint8_t* un_s, uint8_t* un_e,
                               int32_t* bk_s, int32_t* bk_e, float* cur_s, float* cur_e, int n,
                               int n_iters, float thr, float ls, int line_step_iters,
                               int gate_end, const float* w0, const float* b0,
                               const float* wh_t, const float* bh, const float* wout,
                               const float* bout, int hidden, int n_hidden, unsigned skip,
                               int final_tanh, int bf16, void* stream) {
  if (hidden % 32 != 0 || hidden < 32 || hidden > 256 || n_hidden < 0 || n < 0 ||
      n_iters < 0 || (skip & 1u))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || n_iters == 0) return 0;
  const Net net{w0, b0, wh_t, bh, wout, bout, n_hidden, skip, final_tanh, bf16};
  const State st{acc_s, acc_e, sdf_s, sdf_e, un_s, un_e, bk_s, bk_e, cur_s, cur_e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden / 32) {
#define CASE(NJ) \
  case NJ: return launch<NJ>(net, cam, dir, st, n, n_iters, thr, ls, line_step_iters, gate_end, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
