// In-kernel sphere-trace march: a fixed number of fused-backstep iterations
// of both ray fronts against the SDF MLP (SIREN or IGR), on the tensor-core
// tile.
//
// Replaces `_march_kernel` (isopoints_tpu/ops/pallas_trace.py:43, reached by
// `make_trace_stepper` :103, pallas_call :150) for both fields (the SIREN
// instance :121-122): the activation is a template parameter of the kernel
// and of mlp_mma::tile(), IgrAct (softplus, the skip mask, the final tanh)
// or SirenAct (sin of omega z with the first layer's and the other layers'
// omegas, no skip, no tanh). Per
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
// Design. A block takes 64 rays, 512 threads (above width 256 a unit of two
// blocks on mlp_wide.cuh's 64-row tile takes 32 rays). Every iteration threads
// 0..63 write their ray's two front points (cam + acc * dir, one __fmaf_rn
// per coordinate, as the PyTorch loop forms them with utils.fma) as rows r
// and 64 + r of one 128-row tile, the whole block evaluates the tile on the
// tensor cores (mlp_mma::tile, the fused MLP kernels' per-row arithmetic),
// and threads 0..63 update the state. Each update is a separate IEEE
// operation (__fadd_rn/__fmul_rn) so that no contraction into an FMA changes
// it: the march equals the PyTorch loop over the fused MLP kernel
// (fused_igr.cu, fused_mlp.cu) of the same field and mode bit for bit. A ray's ten state scalars, its front moves and its geometry live in
// shared memory between the updates: the tile takes the 128 registers a
// thread has at 512 threads, and a value held across it would spill.
//
// Bound on an H100: operations, 2 * n_iters MLP evals per ray (~0.40 MFLOP
// each at 3x256 SIREN or 4x256 IGR), in the f32 mode three tf32 passes over
// the tf32 peak, in the bf16 mode one pass over the bf16 peak; the
// bytes moved are 24 of rays plus 2 * 34 of state per ray. What the design
// does about it: both fronts of 64 rays fill one 128-row tile, so every
// streamed weight chunk serves 128 evals; the tile's f32 mode is bound by
// its products (three m16n8k8 passes; see fused_igr.cu).

#include <stdint.h>

#include "mlp_mma.cuh"
#ifdef MLP_MMA_WIDE_LIB
#include "mlp_wide.cuh"
#endif

namespace {

using mlp_mma::Bf16Mode;
using mlp_mma::IgrAct;
using mlp_mma::Net;
using mlp_mma::SirenAct;
using mlp_mma::Tf32x3Mode;

// RG row groups a block (mlp_mma::max_row_groups: 4 up to 256), so a tile
// of 32 RG rows and 16 RG rays a block: both fronts in one tile (above 256:
// the wide kernel below)
template <class Mode, int H>
constexpr int kRG = mlp_mma::max_row_groups<Mode>(H);
// per ray in shared memory, [field][kRays]
constexpr int kRayFloats = 14;  // cam xyz, dir xyz, acc_s, acc_e, sdf_s, sdf_e, cur_s,
                                // cur_e, fwd_s, fwd_e
constexpr int kRayInts = 4;     // un_s, un_e, bk_s, bk_e

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

#ifndef MLP_MMA_WIDE_LIB
template <class Mode, int H>
constexpr int smem_bytes() {
  constexpr int kRows = 32 * kRG<Mode, H>, kRays = kRows / 2;
  return kRows * mlp_mma::pitch_a<Mode>(H) + 2 * mlp_mma::stage_bytes<Mode>(H) +
         4 * (kRows * 3 + kRows + kRays * (kRayFloats + kRayInts));
}

template <class Mode, class Act, int H>
__global__ void __launch_bounds__(128 * kRG<Mode, H>, 1)
    march_kernel(Net net, const float* __restrict__ cam, const float* __restrict__ dir,
                 State st, int n, int n_iters, float thr, float ls, int line_step_iters,
                 int gate_end) {
  constexpr int RG = kRG<Mode, H>;
  constexpr int kRows = 32 * RG;   // rows of a tile
  constexpr int kRays = kRows / 2;  // rays per block
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* act = smem;
  unsigned char* wbuf = act + kRows * mlp_mma::pitch_a<Mode>(H);
  float* xs = reinterpret_cast<float*>(wbuf + 2 * mlp_mma::stage_bytes<Mode>(H));
  float* vs = xs + kRows * 3;  // (kRows,)
  float* F = vs + kRows;       // (kRayFloats, kRays)
  int* I = reinterpret_cast<int*>(F + kRayFloats * kRays);  // (kRayInts, kRays)

  const int r = threadIdx.x;
  const int g = blockIdx.x * kRays + r;
  const bool mine = r < kRays && g < n;
  // thread r < kRays: its ray's slots (the other threads never touch theirs)
  const int q = min(r, kRays - 1);
  float* const c = F + q;              // c[k * kRays], k < 3
  float* const d = F + 3 * kRays + q;  // d[k * kRays]
  float& acc_s = F[6 * kRays + q];
  float& acc_e = F[7 * kRays + q];
  float& sdf_s = F[8 * kRays + q];
  float& sdf_e = F[9 * kRays + q];
  float& cur_s = F[10 * kRays + q];
  float& cur_e = F[11 * kRays + q];
  float& fwd_s = F[12 * kRays + q];
  float& fwd_e = F[13 * kRays + q];
  int& un_s = I[q];
  int& un_e = I[kRays + q];
  int& bk_s = I[2 * kRays + q];
  int& bk_e = I[3 * kRays + q];
  if (r < kRays) {  // a ray past n sits at the origin, finished
    for (int k = 0; k < 3; ++k) {
      c[k * kRays] = mine ? cam[(size_t)g * 3 + k] : 0.f;
      d[k * kRays] = mine ? dir[(size_t)g * 3 + k] : 0.f;
    }
    acc_s = mine ? st.acc_s[g] : 0.f;
    acc_e = mine ? st.acc_e[g] : 0.f;
    sdf_s = mine ? st.sdf_s[g] : 0.f;
    sdf_e = mine ? st.sdf_e[g] : 0.f;
    un_s = mine ? st.un_s[g] != 0 : 0;
    un_e = mine ? st.un_e[g] != 0 : 0;
    bk_s = mine ? st.bk_s[g] : 0;
    bk_e = mine ? st.bk_e[g] : 0;
    cur_s = mine ? st.cur_s[g] : 0.f;
    cur_e = mine ? st.cur_e[g] : 0.f;
  }

  for (int it = 0; it < n_iters; ++it) {
    if (r < kRays) {
      fwd_s = (un_s && bk_s == 0 && sdf_s > thr) ? sdf_s : 0.f;
      fwd_e = (un_e && bk_e == 0 && sdf_e > thr) ? sdf_e : 0.f;
      const float scale_s = ldexpf(ls, 1 - bk_s);  // ls * 2^-(bk - 1), exact
      const float scale_e = ldexpf(ls, 1 - bk_e);
      const float move_s = bk_s > 0 ? __fmul_rn(-scale_s, cur_s) : fwd_s;
      const float move_e = bk_e > 0 ? __fmul_rn(-scale_e, cur_e) : fwd_e;
      acc_s = __fadd_rn(acc_s, move_s);
      acc_e = __fsub_rn(acc_e, move_e);
      for (int k = 0; k < 3; ++k) {
        xs[r * 3 + k] = __fmaf_rn(acc_s, d[k * kRays], c[k * kRays]);
        xs[(kRays + r) * 3 + k] = __fmaf_rn(acc_e, d[k * kRays], c[k * kRays]);
      }
    }
    // starts with a barrier (the points visible) and ends with one (vs
    // visible, xs free for the next iteration's points)
    mlp_mma::tile<Mode, H, 1, Act, RG>(net, xs, act, wbuf, 0, kRows, vs, nullptr);
    if (r < kRays) {
      const float new_s = vs[r], new_e = vs[kRays + r];
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

template <class Mode, class Act, int H>
int launch(const Net& net, const float* cam, const float* dir, const State& st, int n,
           int n_iters, float thr, float ls, int line_step_iters, int gate_end,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<Mode, H>();
  static_assert(smem <= 232448, "the march exceeds a block's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      march_kernel<Mode, Act, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int kRays = 16 * kRG<Mode, H>;
  const int blocks = (n + kRays - 1) / kRays;
  march_kernel<Mode, Act, H><<<blocks, 128 * kRG<Mode, H>, smem, stream>>>(
      net, cam, dir, st, n, n_iters, thr, ls, line_step_iters, gate_end);
  return (int)cudaGetLastError();
}

#else
// The wide instances (mlp_wide.cuh): a unit of two blocks marches 32 rays,
// both fronts in its 64-row tile. The kernel above, on the wide tile's
// consumer threads: both blocks of the unit hold the rays' state and update
// it alike, the unit's block 0 writes it back; the producer's warpgroup
// streams every iteration's weights.
constexpr int kWideRays = 32;  // mlp_wide::kRows / 2

template <int H>
constexpr int wide_smem_bytes() {
  return mlp_wide::smem_bytes<H, 1>() +
         4 * (2 * kWideRays * 3 + 2 * kWideRays + kWideRays * (kRayFloats + kRayInts));
}

template <class Mode, class Act, int H>
__global__ void __launch_bounds__(mlp_wide::kThreads, 1)
    wide_march_kernel(Net net, const float* __restrict__ cam, const float* __restrict__ dir,
                      State st, int n, int n_iters, float thr, float ls, int line_step_iters,
                      int gate_end) {
  constexpr int kRows = mlp_wide::kRows, kRays = kWideRays;
  static_assert(kRows == 2 * kRays, "both fronts in one tile");
  extern __shared__ __align__(128) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  mlp_wide::Ctx c = mlp_wide::setup<H, 1>(smem);
  if (threadIdx.x >= mlp_wide::kConsumers) {
    mlp_wide::producer_regs();
    if (threadIdx.x < mlp_wide::kConsumers + 32)
      for (int it = 0; it < n_iters; ++it) mlp_wide::produce<Mode, H>(c, net);
    return;
  }
  mlp_wide::consumer_regs();
  float* xs = reinterpret_cast<float*>(smem + mlp_wide::smem_bytes<H, 1>());
  float* vs = xs + kRows * 3;  // (kRows,)
  float* F = vs + kRows;       // (kRayFloats, kRays)
  int* I = reinterpret_cast<int*>(F + kRayFloats * kRays);  // (kRayInts, kRays)
  const int r = threadIdx.x;
  const int g = (int)(blockIdx.x >> 1) * kRays + r;
  const bool mine = r < kRays && g < n;
  const int q = min(r, kRays - 1);
  // field k of this thread's ray: cam xyz 0-2, dir xyz 3-5, then acc_s,
  // acc_e, sdf_s, sdf_e, cur_s, cur_e, fwd_s, fwd_e; un_s, un_e, bk_s, bk_e
  enum { ACC_S = 6, ACC_E, SDF_S, SDF_E, CUR_S, CUR_E, FWD_S, FWD_E };
  enum { UN_S, UN_E, BK_S, BK_E };
  auto f = [F, q](int k) -> float& { return F[k * kRays + q]; };
  auto u = [I, q](int k) -> int& { return I[k * kRays + q]; };
  if (r < kRays) {  // a ray past n sits at the origin, finished
    for (int k = 0; k < 3; ++k) {
      f(k) = mine ? cam[(size_t)g * 3 + k] : 0.f;
      f(3 + k) = mine ? dir[(size_t)g * 3 + k] : 0.f;
    }
    f(ACC_S) = mine ? st.acc_s[g] : 0.f;
    f(ACC_E) = mine ? st.acc_e[g] : 0.f;
    f(SDF_S) = mine ? st.sdf_s[g] : 0.f;
    f(SDF_E) = mine ? st.sdf_e[g] : 0.f;
    u(UN_S) = mine ? st.un_s[g] != 0 : 0;
    u(UN_E) = mine ? st.un_e[g] != 0 : 0;
    u(BK_S) = mine ? st.bk_s[g] : 0;
    u(BK_E) = mine ? st.bk_e[g] : 0;
    f(CUR_S) = mine ? st.cur_s[g] : 0.f;
    f(CUR_E) = mine ? st.cur_e[g] : 0.f;
  }

  for (int it = 0; it < n_iters; ++it) {
    if (r < kRays) {
      const int un_s = u(UN_S), un_e = u(UN_E), bk_s = u(BK_S), bk_e = u(BK_E);
      const float sdf_s = f(SDF_S), sdf_e = f(SDF_E);
      const float fwd_s = (un_s && bk_s == 0 && sdf_s > thr) ? sdf_s : 0.f;
      const float fwd_e = (un_e && bk_e == 0 && sdf_e > thr) ? sdf_e : 0.f;
      f(FWD_S) = fwd_s;
      f(FWD_E) = fwd_e;
      const float scale_s = ldexpf(ls, 1 - bk_s);  // ls * 2^-(bk - 1), exact
      const float scale_e = ldexpf(ls, 1 - bk_e);
      const float move_s = bk_s > 0 ? __fmul_rn(-scale_s, f(CUR_S)) : fwd_s;
      const float move_e = bk_e > 0 ? __fmul_rn(-scale_e, f(CUR_E)) : fwd_e;
      const float acc_s = __fadd_rn(f(ACC_S), move_s);
      const float acc_e = __fsub_rn(f(ACC_E), move_e);
      f(ACC_S) = acc_s;
      f(ACC_E) = acc_e;
      for (int k = 0; k < 3; ++k) {
        xs[r * 3 + k] = __fmaf_rn(acc_s, f(3 + k), f(k));
        xs[(kRays + r) * 3 + k] = __fmaf_rn(acc_e, f(3 + k), f(k));
      }
    }
    // starts with a barrier (the points visible) and ends with the pair's
    // (vs complete in both blocks, xs free for the next iteration's points)
    mlp_wide::tile<Mode, H, 1, Act, true>(c, net, xs, 0, kRows, vs, nullptr);
    if (r < kRays) {
      const float new_s = vs[r], new_e = vs[kRays + r];
      int un_s = u(UN_S), un_e = u(UN_E), bk_s = u(BK_S), bk_e = u(BK_E);
      const bool may_s = un_s && new_s < 0.f && bk_s < line_step_iters;
      const bool may_e = un_e && new_e < 0.f && bk_e < line_step_iters;
      if (may_s && bk_s == 0) f(CUR_S) = f(FWD_S);
      if (may_e && bk_e == 0) f(CUR_E) = f(FWD_E);
      bk_s = may_s ? bk_s + 1 : 0;
      bk_e = may_e ? bk_e + 1 : 0;
      const bool not_crossed = f(ACC_S) < f(ACC_E);
      un_s = un_s && (bk_s > 0 || (new_s > thr && not_crossed));
      un_e = un_e && (bk_e > 0 || (new_e > thr && not_crossed));
      if (gate_end) un_e = un_e && (un_s || bk_e > 0);
      u(UN_S) = un_s;
      u(UN_E) = un_e;
      u(BK_S) = bk_s;
      u(BK_E) = bk_e;
      f(SDF_S) = new_s;
      f(SDF_E) = new_e;
    }
  }

  if (mine && c.cb == 0) {
    st.acc_s[g] = f(ACC_S);
    st.acc_e[g] = f(ACC_E);
    st.sdf_s[g] = f(SDF_S);
    st.sdf_e[g] = f(SDF_E);
    st.un_s[g] = u(UN_S) ? 1 : 0;
    st.un_e[g] = u(UN_E) ? 1 : 0;
    st.bk_s[g] = u(BK_S);
    st.bk_e[g] = u(BK_E);
    st.cur_s[g] = f(CUR_S);
    st.cur_e[g] = f(CUR_E);
  }
  mlp_wide::finish();
}

template <class Mode, class Act, int H>
int launch(const Net& net, const float* cam, const float* dir, const State& st, int n,
           int n_iters, float thr, float ls, int line_step_iters, int gate_end,
           cudaStream_t stream) {
  constexpr int smem = wide_smem_bytes<H>();
  static_assert(smem <= 232448, "the march exceeds a block's shared memory");
  static int limit = -1;
  return (int)mlp_wide::launch(wide_march_kernel<Mode, Act, H>, (n + kWideRays - 1) / kWideRays,
                               smem, limit, stream, net, cam, dir, st, n, n_iters, thr, ls,
                               line_step_iters, gate_end);
}
#endif

template <class Mode, class Act>
int dispatch(int hidden, const Net& net, const float* cam, const float* dir, const State& st,
             int n, int n_iters, float thr, float ls, int line_step_iters, int gate_end,
             cudaStream_t s) {
  switch (hidden / 32) {
#define CASE(NJ)                                                                           \
  case NJ:                                                                                 \
    return launch<Mode, Act, NJ * 32>(net, cam, dir, st, n, n_iters, thr, ls,            \
                                      line_step_iters, gate_end, s);
    MLP_MMA_WIDTHS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cam, dir (n, 3); the ten state arrays (n,) are updated in place: acc_s,
// acc_e, sdf_s, sdf_e, cur_s, cur_e float32, un_s, un_e uint8 (0/1), bk_s,
// bk_e int32. `ls` is 1 - line_search_step. The net is mlp_mma::Net's seven
// pointers (w0, b0, wh, wh_lo, bh, wout, bout) of the callable's mode
// (`bf16`, or f32 as 3xTF32 with wh_lo the tf32 lo part); `siren` selects
// the sine activation with its omegas (otherwise IGR's softplus with the
// skip mask and final tanh). hidden is an instance's width
// (mlp_mma::in_library).
extern "C" int trace_march(const float* cam, const float* dir, float* acc_s, float* acc_e,
                           float* sdf_s, float* sdf_e, uint8_t* un_s, uint8_t* un_e,
                           int32_t* bk_s, int32_t* bk_e, float* cur_s, float* cur_e, int n,
                           int n_iters, float thr, float ls, int line_step_iters, int gate_end,
                           const float* w0, const float* b0, const void* wh, const void* wh_lo,
                           const float* bh, const float* wout, const float* bout, int hidden,
                           int n_hidden, unsigned skip, int final_tanh, float omega_first,
                           float omega_hidden, int siren, int bf16, void* stream) {
  if (!mlp_mma::in_library(hidden) || n_hidden < 0 || n < 0 ||
      n_iters < 0 || (skip & 1u) ||
      (n_hidden > 0 && (wh == nullptr || (!bf16 && mlp_mma::kLoApart && wh_lo == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || n_iters == 0) return 0;
  const Net net{w0,       b0,         wh,          wh_lo,       bh,   wout, bout, n_hidden,
                skip,     final_tanh, omega_first, omega_hidden};
  const State st{acc_s, acc_e, sdf_s, sdf_e, un_s, un_e, bk_s, bk_e, cur_s, cur_e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto mode, auto act) {
    using Mode = decltype(mode);
    using Act = decltype(act);
    return dispatch<Mode, Act>(hidden, net, cam, dir, st, n, n_iters, thr, ls, line_step_iters,
                               gate_end, s);
  };
  if (siren) return bf16 ? run(Bf16Mode{}, SirenAct{}) : run(Tf32x3Mode{}, SirenAct{});
  return bf16 ? run(Bf16Mode{}, IgrAct{}) : run(Tf32x3Mode{}, IgrAct{});
}
