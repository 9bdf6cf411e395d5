// Fused dense ray sampler: sweep + first-sign-change pick + min-SDF argmin
// [+ fine re-validation of the bracket] + fixed-step secant, all against the
// SDF MLP (SIREN or IGR) on the tensor-core tile, in one kernel.
//
// Replaces `_sweep_kernel` (isopoints_tpu/ops/pallas_sampler.py:52, reached
// by `make_sampler` :129, pallas_call :187), for both fields and both sweep
// precisions: per ray, n_steps proposals t_s = t_lo + steps[s] (t_hi - t_lo);
// the pick is the argmin of sign(f + margin) * (n_steps - s) (the first
// minimum, as argmin), the bracket low end is idx_lo = max(idx - 1, 0), the
// argmin of f gives t_min, and n_secant secant steps with eps_denom(., 1e-12)
// refine the bracket. With `revalidate` (the coarse sweep, :97-104) the sweep
// runs on the coarse (bf16) net and the bracket ends [z_low, t_pick] are
// evaluated again by the fine net before the secant, which runs fine; f_pick
// is then the fine value. Outputs (t_pick, f_pick, t_min, z_secant).
//
// The TPU kernel sweeps the steps one after another in a loop carry over a
// 512-ray tile. Here the proposals of a ray are independent MLP evals that
// fill MLP tiles, and only the pick is sequential. A block of 512 threads
// takes `rays` rays (a power of two from 8 to 64, chosen by the wrapper from
// the ray count), and each 128-row sweep tile of mlp_mma.cuh holds
// 128 / rays consecutive steps of every one of them (row j * rays + r: step
// j of ray r; a ragged last tile and the rays past n_rays are masked). After
// each sweep tile thread r < rays folds its ray's new values, in step order,
// into a streaming pick (`fold`, the Pallas kernel's carry cut at tile
// boundaries), so no proposal buffer is needed and n_steps has no limit. The
// sweep runs in the bf16 mode under `revalidate` (the coarse sweep) and
// otherwise in the fine mode; the re-validation tile (rows r: z_low of ray r,
// rays + r: its t_pick) and each secant step's tile (row r: ray r) run in
// the fine mode (3xTF32, or bf16 for a bf16 callable). The activation is a
// template parameter, mlp_mma::IgrAct or mlp_mma::SirenAct. Every point goes
// through mlp_mma::tile(), which gives a row the same value as the fused MLP
// kernels do (fused_igr.cu, fused_mlp.cu) whatever rows share its tile, so
// the sampler equals `sweep_plain` over the fused callables bit for bit.
//
// Bound on an H100: operations, n_steps sweep evals per ray (bf16: one pass
// over the bf16 tensor-core peak; fine: three tf32 passes over the tf32 peak)
// and n_secant [+ 2] fine evals, ~0.40 MFLOP each at 3x256 (SIREN) or 4x256
// (IGR); the bytes moved are 32 per ray in and 16 out. What the design does
// about it: the sweep, ~90% of the FLOP, runs on the tensor cores in
// 128-row tiles that share each streamed weight chunk. The rays a block
// trade the number of blocks against the tiles a block runs: a block runs
// ceil(n_steps rays / 128) sweep tiles, one re-validation tile and one tile a
// secant step whatever its rays, and every tile streams the whole weight
// stack. At the bench trace's 24,576 rays 64 rays a block (384 blocks) took
// 18.4 ms on an H100, 32 took 23.6 and 128 took 20.8 (PERF.md); a training
// step's ~1-2k sampler rays would fill 16-32 of the 132 SMs at 64. So the
// wrapper takes the rays a block with the fewest tile rounds on the busiest
// SM, waves of blocks times tiles a block (ops/fused_sampler.rays_per_block:
// 64 at the bench trace's buffer, 8-16 at a training step's). Above width
// 256 the sampler runs on mlp_wide.cuh's tile: a unit of two blocks (the
// cluster pair that shares a 64-row tile) takes 8 to 32 rays, and its bf16
// sweep tiles and f32 re-validation and secant tiles have 64 rows in the
// same shared memory (A at the f32 pitch, the bf16 tile using a prefix),
// so the f32 tail's weight streams serve up to 32 rays.
//
// t = t_lo + step * span and the points cam + t * dir are single-rounding
// fused multiply-adds (__fmaf_rn), as XLA forms them in the JAX package and
// as the plain PyTorch version forms them (utils.fma), so the proposals
// agree bit for bit and only the MLP arithmetic may differ.

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

__device__ __forceinline__ float eps_denom(float x, float eps) {
  const float a = fabsf(x);
  return (x < 0.f ? -1.f : 1.f) * (a < eps ? eps : a);
}

// -fl (zh - zl) / eps_denom(fh - fl, 1e-12) + zl, rounded step by step
__device__ __forceinline__ float z_pred(float fl, float fh, float zl, float zh) {
  const float num = __fmul_rn(-fl, __fsub_rn(zh, zl));
  return __fadd_rn(__fdiv_rn(num, eps_denom(__fsub_rn(fh, fl), 1e-12f)), zl);
}

// A block of width H (up to 256) holds RG = 4 row groups: its tiles have
// 128 rows and it has 512 threads. It takes at most 16 RG rays (64): the
// re-validation tile holds two rows a ray. kMaxRays is the per-ray arrays'
// width. (Above 256: the wide kernel below.)
template <int H>
constexpr int kRG = mlp_mma::max_row_groups<Tf32x3Mode>(H);
template <int H>
constexpr int kMaxRays = 16 * kRG<H>;
constexpr int kMinRays = 8;

// A ray's streaming pick: the TPU kernel's carry, the argmin of
// sign(f + margin) * (n_steps - s) and the argmin of f, one step at a time.
// A step wins where it is strictly below the best so far, so the first
// minimum is kept and a NaN step never wins (sign(NaN) is NaN).
struct Pick {
  float best, t_pick, f_pick, z_low, f_low, prev_t, prev_f, f_min, t_min;
};
constexpr int kPickFloats = 9;

// ray r's pick from / to its column of the (kPickFloats, M) array
template <int M>
__device__ __forceinline__ Pick load_pick(const float* pk, int r) {
  return Pick{pk[r],         pk[M + r],     pk[2 * M + r], pk[3 * M + r], pk[4 * M + r],
              pk[5 * M + r], pk[6 * M + r], pk[7 * M + r], pk[8 * M + r]};
}

template <int M>
__device__ __forceinline__ void store_pick(float* pk, int r, const Pick& k) {
  const float f[kPickFloats] = {k.best,   k.t_pick, k.f_pick, k.z_low, k.f_low,
                                k.prev_t, k.prev_f, k.f_min,  k.t_min};
#pragma unroll
  for (int i = 0; i < kPickFloats; ++i) pk[i * M + r] = f[i];
}

__device__ __forceinline__ void fold(Pick& k, int s, int n_steps, float ts, float fs,
                                     float margin) {
  const float v = __fadd_rn(fs, margin);
  const float sgn = isnan(v) ? NAN : (float)((v > 0.f) - (v < 0.f));
  const float cost = sgn * (float)(n_steps - s);
  const float pt = s == 0 ? ts : k.prev_t;
  const float pf = s == 0 ? fs : k.prev_f;
  if (cost < k.best) {
    k.best = cost;
    k.t_pick = ts;
    k.f_pick = fs;
    k.z_low = pt;
    k.f_low = pf;
  }
  if (fs < k.f_min) {
    k.f_min = fs;
    k.t_min = ts;
  }
  k.prev_t = ts;
  k.prev_f = fs;
}

// Shared memory: the tile at its f32 size (the bf16 tile uses a prefix of
// it), the tile's points and values, then per ray (struct of arrays,
// [field][kMaxRays]) its geometry (cam, dir, t_lo, span), its pick and its
// secant state (fl, fh, zl, zh, z).
constexpr int kRayFloats = 8 + kPickFloats + 5;

#ifndef MLP_MMA_WIDE_LIB
template <int H>
__host__ __device__ constexpr int act_bytes() {
  return 32 * kRG<H> * mlp_mma::pitch_a<Tf32x3Mode>(H);
}

template <int H>
constexpr int smem_bytes() {
  return act_bytes<H>() + 2 * mlp_mma::stage_bytes<Tf32x3Mode>(H) +
         4 * (32 * kRG<H> * 4 + kMaxRays<H> * kRayFloats);
}

// Every tile of a block goes through one loop with one call of the tile per
// mode: the sweep tiles (sweep net), the re-validation tile when
// `revalidate`, then the secant tiles (fine net).
template <class Act, int H>
__global__ void __launch_bounds__(128 * kRG<H>, 1)
    sweep_kernel(Net sweep_net, Net fine_net, int sweep_bf16, int fine_bf16, int revalidate,
                 int rays, const float* __restrict__ cam, const float* __restrict__ dir,
                 const float* __restrict__ t_lo, const float* __restrict__ t_hi,
                 const float* __restrict__ steps, int n_rays, int n_steps, int n_secant,
                 float margin, float* __restrict__ t_pick_out, float* __restrict__ f_pick_out,
                 float* __restrict__ t_min_out, float* __restrict__ z_sec_out) {
  constexpr int RG = kRG<H>;
  constexpr int kRows = 32 * RG;   // rows of a tile
  constexpr int M = kMaxRays<H>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* act = smem;
  unsigned char* wbuf = act + act_bytes<H>();
  float* xs = reinterpret_cast<float*>(wbuf + 2 * mlp_mma::stage_bytes<Tf32x3Mode>(H));
  float* vs = xs + kRows * 3;             // (kRows,)
  float* ray = vs + kRows;           // (8, M): cam xyz, dir xyz, t_lo, span
  float* pk = ray + 8 * M;           // (kPickFloats, M)
  float* sec = pk + kPickFloats * M;  // (5, M): fl, fh, zl, zh, z
  auto R = [&](int f, int r) -> float& { return ray[f * M + r]; };
  auto S = [&](int f, int r) -> float& { return sec[f * M + r]; };

  const int per_tile = kRows / rays;  // steps of each ray per sweep tile
  const int r0 = blockIdx.x * rays;
  const int nr = min(rays, n_rays - r0);
  const int tid = threadIdx.x;
  if (tid < rays) {  // masked rays sit at the origin with t = 0
    const bool ok = tid < nr;
    const size_t g = (size_t)(r0 + tid);
    for (int d = 0; d < 3; ++d) {
      R(d, tid) = ok ? cam[g * 3 + d] : 0.f;
      R(3 + d, tid) = ok ? dir[g * 3 + d] : 0.f;
    }
    const float lo = ok ? t_lo[g] : 0.f;
    const float hi = ok ? t_hi[g] : 0.f;
    R(6, tid) = lo;
    R(7, tid) = __fsub_rn(hi, lo);
    store_pick<M>(pk, tid, Pick{INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, INFINITY, 0.f});
  }
  __syncthreads();  // every row's thread reads its ray's geometry
  // the point at depth z on ray r
  auto point = [&](int r, float z, float* p) {
    for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R(3 + d, r), R(d, r));
  };
  // thread r < rays: the pick is done; the outputs, and the bracket as the
  // secant state
  auto finish_pick = [&]() {
    if (tid < rays) {
      const Pick k = load_pick<M>(pk, tid);
      S(0, tid) = k.f_low;
      S(1, tid) = k.f_pick;
      S(2, tid) = k.z_low;
      S(3, tid) = k.t_pick;
      if (tid < nr) {
        t_pick_out[r0 + tid] = k.t_pick;
        f_pick_out[r0 + tid] = k.f_pick;
        t_min_out[r0 + tid] = k.t_min;
      }
    }
    __syncthreads();
  };

  // rays <= M: one re-validation tile (2 rays rows) and one tile a secant step
  const int n_sweep = (n_steps + per_tile - 1) / per_tile;
  const int n_reval = revalidate ? 1 : 0;
  const int n_tiles = n_sweep + n_reval + n_secant;
  for (int it = 0; it < n_tiles; ++it) {
    const bool sweeping = it < n_sweep;
    const bool reval = !sweeping && it < n_sweep + n_reval;
    if (it == n_sweep) finish_pick();
    // ---- the tile's points (thread q < kRows: row q)
    if (tid < kRows) {
      float p[3] = {0.f, 0.f, 0.f};
      if (sweeping) {
        const int j = tid / rays, r = tid - j * rays;
        const int s = it * per_tile + j;
        if (s < n_steps && r < nr) point(r, __fmaf_rn(__ldg(steps + s), R(7, r), R(6, r)), p);
      } else if (reval) {  // rows r: z_low of ray r; rays + r: its t_pick
        if (tid < 2 * rays) point(tid % rays, S(tid < rays ? 2 : 3, tid % rays), p);
      } else if (tid < rays) {
        const float z = z_pred(S(0, tid), S(1, tid), S(2, tid), S(3, tid));
        S(4, tid) = z;
        point(tid, z, p);
      }
      for (int d = 0; d < 3; ++d) xs[tid * 3 + d] = p[d];
    }
    // the net by value: a reference to a kernel parameter chosen at run
    // time would make the tile read it through local memory
    const Net net = sweeping ? sweep_net : fine_net;
    if (sweeping ? sweep_bf16 : fine_bf16)
      mlp_mma::tile<Bf16Mode, H, 1, Act, RG>(net, xs, act, wbuf, 0, kRows, vs, nullptr);
    else
      mlp_mma::tile<Tf32x3Mode, H, 1, Act, RG>(net, xs, act, wbuf, 0, kRows, vs, nullptr);
    // ---- its values
    if (sweeping) {
      if (tid < rays) {
        Pick k = load_pick<M>(pk, tid);
        for (int j = 0; j < per_tile; ++j) {
          const int s = it * per_tile + j;
          if (s < n_steps)
            fold(k, s, n_steps, __fmaf_rn(__ldg(steps + s), R(7, tid), R(6, tid)),
                 vs[j * rays + tid], margin);
        }
        store_pick<M>(pk, tid, k);
      }
    } else if (reval) {
      if (tid < 2 * rays) {
        const int r = tid % rays;
        S(tid < rays ? 0 : 1, r) = vs[tid];
        if (tid >= rays && r < nr) f_pick_out[r0 + r] = vs[tid];  // fine f_pick
      }
    } else if (tid < rays) {
      const float f_mid = vs[tid];
      if (f_mid > 0.f) {
        S(0, tid) = f_mid;
        S(2, tid) = S(4, tid);
      }
      if (f_mid < 0.f) {
        S(1, tid) = f_mid;
        S(3, tid) = S(4, tid);
      }
    }
    __syncthreads();  // the secant state of every ray visible to the next tile's rows
  }
  if (n_tiles == n_sweep) finish_pick();  // no fine tiles
  if (tid < nr) z_sec_out[r0 + tid] = z_pred(S(0, tid), S(1, tid), S(2, tid), S(3, tid));
}

template <class Act, int H>
int launch(const Net& sweep, const Net& fine, int sweep_bf16, int fine_bf16, int revalidate,
           int rays, const float* cam, const float* dir, const float* t_lo, const float* t_hi,
           const float* steps, int n_rays, int n_steps, int n_secant, float margin,
           float* t_pick, float* f_pick, float* t_min, float* z_sec, cudaStream_t stream) {
  constexpr int smem = smem_bytes<H>();
  static_assert(smem <= 232448, "the sampler exceeds a block's shared memory");
  static_assert(2 * kMaxRays<H> <= 32 * kRG<H>, "the re-validation tile holds two rows a ray");
  if (rays > kMaxRays<H>) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_kernel<Act, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (n_rays + rays - 1) / rays;
  sweep_kernel<Act, H><<<blocks, 128 * kRG<H>, smem, stream>>>(
      sweep, fine, sweep_bf16, fine_bf16, revalidate, rays, cam, dir, t_lo, t_hi, steps, n_rays,
      n_steps, n_secant, margin, t_pick, f_pick, t_min, z_sec);
  return (int)cudaGetLastError();
}

#else
// The wide instances (mlp_wide.cuh): a unit of two blocks, the cluster pair
// that shares a 64-row tile, takes `rays` rays (8 to 32; the re-validation
// tile holds two rows a ray).
constexpr int kWideRays = 32;

constexpr int wide_arrays_bytes() {
  return 4 * (mlp_wide::kRows * 4 + kWideRays * kRayFloats);
}

// The kernel above on the wide tile's consumer threads: unit u's rays [r0,
// r0 + rays) over 64-row tiles, both blocks of the unit holding the rays'
// state and folding the same values alike, block 0 writing the outputs.
// `smem` holds the points, values and per-ray arrays (wide_arrays_bytes).
template <class Act, int H>
__device__ __forceinline__ void wide_sweep_rays(
    mlp_wide::Ctx& c, float* smem, const Net& sweep_net, const Net& fine_net, int sweep_bf16,
    int fine_bf16, int revalidate, int rays, int r0, const float* __restrict__ cam,
    const float* __restrict__ dir, const float* __restrict__ t_lo,
    const float* __restrict__ t_hi, const float* __restrict__ steps, int n_rays, int n_steps,
    int n_secant, float margin, float* __restrict__ t_pick_out, float* __restrict__ f_pick_out,
    float* __restrict__ t_min_out, float* __restrict__ z_sec_out) {
  constexpr int kR = mlp_wide::kRows;  // rows of a tile
  constexpr int M = kWideRays;
  float* xs = smem;                   // (kR, 3)
  float* vs = xs + kR * 3;            // (kR,)
  float* ray = vs + kR;               // (8, M): cam xyz, dir xyz, t_lo, span
  float* pk = ray + 8 * M;            // (kPickFloats, M)
  float* sec = pk + kPickFloats * M;  // (5, M): fl, fh, zl, zh, z
  auto R = [&](int f, int r) -> float& { return ray[f * M + r]; };
  auto S = [&](int f, int r) -> float& { return sec[f * M + r]; };

  const int per_tile = kR / rays;  // steps of each ray per sweep tile
  const int nr = max(0, min(rays, n_rays - r0));
  const bool out = c.cb == 0;
  const int tid = threadIdx.x;
  if (tid < rays) {  // masked rays sit at the origin with t = 0
    const bool ok = tid < nr;
    const size_t g = (size_t)(r0 + tid);
    for (int d = 0; d < 3; ++d) {
      R(d, tid) = ok ? cam[g * 3 + d] : 0.f;
      R(3 + d, tid) = ok ? dir[g * 3 + d] : 0.f;
    }
    const float lo = ok ? t_lo[g] : 0.f;
    const float hi = ok ? t_hi[g] : 0.f;
    R(6, tid) = lo;
    R(7, tid) = __fsub_rn(hi, lo);
    store_pick<M>(pk, tid, Pick{INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, INFINITY, 0.f});
  }
  mlp_wide::consumer_sync();  // every row's thread reads its ray's geometry
  // the point at depth z on ray r
  auto point = [&](int r, float z, float* p) {
    for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R(3 + d, r), R(d, r));
  };
  // thread r < rays: the pick is done; the outputs, and the bracket as the
  // secant state
  auto finish_pick = [&]() {
    if (tid < rays) {
      const Pick k = load_pick<M>(pk, tid);
      S(0, tid) = k.f_low;
      S(1, tid) = k.f_pick;
      S(2, tid) = k.z_low;
      S(3, tid) = k.t_pick;
      if (out && tid < nr) {
        t_pick_out[r0 + tid] = k.t_pick;
        f_pick_out[r0 + tid] = k.f_pick;
        t_min_out[r0 + tid] = k.t_min;
      }
    }
    mlp_wide::consumer_sync();
  };

  // rays <= M: one re-validation tile (2 rays rows) and one tile a secant step
  const int n_sweep = (n_steps + per_tile - 1) / per_tile;
  const int n_reval = revalidate ? 1 : 0;
  const int n_tiles = n_sweep + n_reval + n_secant;
  for (int it = 0; it < n_tiles; ++it) {
    const bool sweeping = it < n_sweep;
    const bool reval = !sweeping && it < n_sweep + n_reval;
    if (it == n_sweep) finish_pick();
    // ---- the tile's points (thread q < kR: row q)
    if (tid < kR) {
      float p[3] = {0.f, 0.f, 0.f};
      if (sweeping) {
        const int j = tid / rays, r = tid - j * rays;
        const int s = it * per_tile + j;
        if (s < n_steps && r < nr) point(r, __fmaf_rn(__ldg(steps + s), R(7, r), R(6, r)), p);
      } else if (reval) {  // rows r: z_low of ray r; rays + r: its t_pick
        if (tid < 2 * rays) point(tid % rays, S(tid < rays ? 2 : 3, tid % rays), p);
      } else if (tid < rays) {
        const float z = z_pred(S(0, tid), S(1, tid), S(2, tid), S(3, tid));
        S(4, tid) = z;
        point(tid, z, p);
      }
      for (int d = 0; d < 3; ++d) xs[tid * 3 + d] = p[d];
    }
    // the net by value: a reference to a kernel parameter chosen at run
    // time would make the tile read it through local memory
    const Net net = sweeping ? sweep_net : fine_net;
    if (sweeping ? sweep_bf16 : fine_bf16)
      mlp_wide::tile<Bf16Mode, H, 1, Act, true>(c, net, xs, 0, kR, vs, nullptr);
    else
      mlp_wide::tile<Tf32x3Mode, H, 1, Act, true>(c, net, xs, 0, kR, vs, nullptr);
    // ---- its values
    if (sweeping) {
      if (tid < rays) {
        Pick k = load_pick<M>(pk, tid);
        for (int j = 0; j < per_tile; ++j) {
          const int s = it * per_tile + j;
          if (s < n_steps)
            fold(k, s, n_steps, __fmaf_rn(__ldg(steps + s), R(7, tid), R(6, tid)),
                 vs[j * rays + tid], margin);
        }
        store_pick<M>(pk, tid, k);
      }
    } else if (reval) {
      if (tid < 2 * rays) {
        const int r = tid % rays;
        S(tid < rays ? 0 : 1, r) = vs[tid];
        if (out && tid >= rays && r < nr) f_pick_out[r0 + r] = vs[tid];  // fine f_pick
      }
    } else if (tid < rays) {
      const float f_mid = vs[tid];
      if (f_mid > 0.f) {
        S(0, tid) = f_mid;
        S(2, tid) = S(4, tid);
      }
      if (f_mid < 0.f) {
        S(1, tid) = f_mid;
        S(3, tid) = S(4, tid);
      }
    }
    mlp_wide::consumer_sync();  // the secant state of every ray visible to the next tile's rows
  }
  if (n_tiles == n_sweep) finish_pick();  // no fine tiles
  if (out && tid < nr) z_sec_out[r0 + tid] = z_pred(S(0, tid), S(1, tid), S(2, tid), S(3, tid));
}

template <class Act, int H>
__global__ void __launch_bounds__(mlp_wide::kThreads, 1)
    wide_sweep_kernel(Net sweep_net, Net fine_net, int sweep_bf16, int fine_bf16, int revalidate,
                      int rays, const float* __restrict__ cam, const float* __restrict__ dir,
                      const float* __restrict__ t_lo, const float* __restrict__ t_hi,
                      const float* __restrict__ steps, int n_rays, int n_steps, int n_secant,
                      float margin, float* __restrict__ t_pick_out,
                      float* __restrict__ f_pick_out, float* __restrict__ t_min_out,
                      float* __restrict__ z_sec_out) {
  extern __shared__ __align__(128) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  mlp_wide::Ctx c = mlp_wide::setup<H, 1>(smem);
  if (threadIdx.x >= mlp_wide::kConsumers) {
    mlp_wide::producer_regs();
    if (threadIdx.x < mlp_wide::kConsumers + 32) {
      const int per_tile = mlp_wide::kRows / rays;
      const int n_sweep = (n_steps + per_tile - 1) / per_tile;
      const int n_tiles = n_sweep + (revalidate ? 1 : 0) + n_secant;
      for (int it = 0; it < n_tiles; ++it) {
        const bool sweeping = it < n_sweep;
        const Net net = sweeping ? sweep_net : fine_net;
        if (sweeping ? sweep_bf16 : fine_bf16)
          mlp_wide::produce<Bf16Mode, H>(c, net);
        else
          mlp_wide::produce<Tf32x3Mode, H>(c, net);
      }
    }
  } else {
    mlp_wide::consumer_regs();
    float* arrays = reinterpret_cast<float*>(smem + mlp_wide::smem_bytes<H, 1>());
    wide_sweep_rays<Act, H>(c, arrays, sweep_net, fine_net, sweep_bf16, fine_bf16, revalidate,
                       rays, (int)(blockIdx.x >> 1) * rays, cam, dir, t_lo, t_hi, steps, n_rays,
                       n_steps, n_secant, margin, t_pick_out, f_pick_out, t_min_out, z_sec_out);
    mlp_wide::finish();
  }
}

template <class Act, int H>
int launch(const Net& sweep, const Net& fine, int sweep_bf16, int fine_bf16, int revalidate,
           int rays, const float* cam, const float* dir, const float* t_lo, const float* t_hi,
           const float* steps, int n_rays, int n_steps, int n_secant, float margin,
           float* t_pick, float* f_pick, float* t_min, float* z_sec, cudaStream_t stream) {
  constexpr int smem = mlp_wide::smem_bytes<H, 1>() + wide_arrays_bytes();
  static_assert(smem <= 232448, "the sampler exceeds a block's shared memory");
  if (rays > kWideRays) return (int)cudaErrorInvalidValue;
  static int limit = -1;
  return (int)mlp_wide::launch(wide_sweep_kernel<Act, H>, (n_rays + rays - 1) / rays, smem,
                               limit, stream, sweep, fine, sweep_bf16, fine_bf16, revalidate,
                               rays, cam, dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant,
                               margin, t_pick, f_pick, t_min, z_sec);
}
#endif

template <class Act>
int dispatch(int hidden, const Net& sweep, const Net& fine, int sweep_bf16, int fine_bf16,
             int revalidate, int rays, const float* cam, const float* dir, const float* t_lo,
             const float* t_hi, const float* steps, int n_rays, int n_steps, int n_secant,
             float margin, float* t_pick, float* f_pick, float* t_min, float* z_sec,
             cudaStream_t s) {
  switch (hidden / 32) {
#define CASE(NJ)                                                                             \
  case NJ:                                                                                   \
    return launch<Act, NJ * 32>(sweep, fine, sweep_bf16, fine_bf16, revalidate, rays, cam,   \
                                dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant, margin,   \
                                t_pick, f_pick, t_min, z_sec, s);
    MLP_MMA_WIDTHS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// cam, dir (n_rays, 3); t_lo, t_hi (n_rays,); steps (n_steps,) fractions of
// [t_lo, t_hi] -> t_pick, f_pick, t_min, z_secant (n_rays,) each. `sw` and
// `fw` are the seven pointers of mlp_mma::Net (w0, b0, wh, wh_lo, bh, wout,
// bout) of the sweep and the fine net, `sweep_bf16` and `fine_bf16` their
// modes (bf16, or f32 as 3xTF32 with wh_lo the tf32 lo part); `revalidate`
// evaluates the bracket ends again on the fine net before the secant (the
// coarse sweep). `siren` selects the sine activation with its omegas
// (otherwise IGR's softplus with the skip mask and final tanh). `rays` is
// the rays a block (a unit of two blocks above 256), a power of two in [8,
// 64] up to width 256 and in [8, 32] above; hidden is an instance's width
// (mlp_mma::in_library). In the `_wide` library wh is the wide tile's stage
// pack (hi and lo together) and wh_lo unused.
extern "C" int sampler_sweep(const float* cam, const float* dir, const float* t_lo,
                             const float* t_hi, const float* steps, int n_rays, int n_steps,
                             int n_secant, float margin, int revalidate, const void* const* sw,
                             const void* const* fw, int hidden, int n_hidden, unsigned skip,
                             int final_tanh, float omega_first, float omega_hidden, int siren,
                             int sweep_bf16, int fine_bf16, int rays, float* t_pick,
                             float* f_pick, float* t_min, float* z_sec, void* stream) {
  if (!mlp_mma::in_library(hidden) || n_rays < 0 || n_steps < 1 || n_secant < 0 ||
      n_hidden < 0 || (skip & 1u) || rays < kMinRays ||
      (rays & (rays - 1)) != 0 ||
      (n_hidden > 0 && (sw[2] == nullptr || fw[2] == nullptr ||
                        (mlp_mma::kLoApart && ((!sweep_bf16 && sw[3] == nullptr) ||
                                               (!fine_bf16 && fw[3] == nullptr))))))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  auto net = [&](const void* const* w) {
    return Net{static_cast<const float*>(w[0]),
               static_cast<const float*>(w[1]),
               w[2],
               w[3],
               static_cast<const float*>(w[4]),
               static_cast<const float*>(w[5]),
               static_cast<const float*>(w[6]),
               n_hidden,
               skip,
               final_tanh,
               omega_first,
               omega_hidden};
  };
  const Net sweep = net(sw), fine = net(fw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return siren ? dispatch<SirenAct>(hidden, sweep, fine, sweep_bf16, fine_bf16, revalidate, rays,
                                    cam, dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant,
                                    margin, t_pick, f_pick, t_min, z_sec, s)
               : dispatch<IgrAct>(hidden, sweep, fine, sweep_bf16, fine_bf16, revalidate, rays,
                                  cam, dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant, margin,
                                  t_pick, f_pick, t_min, z_sec, s);
}
