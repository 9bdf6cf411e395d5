// Fused dense ray sampler: sweep + first-sign-change pick + min-SDF argmin
// [+ fine re-validation of the bracket] + fixed-step secant, all against the
// SDF MLP (SIREN or IGR), in one kernel.
//
// Replaces `_sweep_kernel` (isopoints_tpu/ops/pallas_sampler.py:52, reached
// by `make_sampler` :129, pallas_call :187): per ray, n_steps proposals
// t_s = t_lo + steps[s] (t_hi - t_lo); the pick is the argmin of
// sign(f + margin) * (n_steps - s) (the first minimum, as argmin), the
// bracket low end is idx_lo = max(idx - 1, 0), the argmin of f gives t_min,
// and n_secant secant steps with eps_denom(., 1e-12) refine the bracket.
// With `revalidate` (the coarse sweep, :97-104) the sweep runs on the coarse
// (bf16) net and the bracket ends [z_low, t_pick] are evaluated again by the
// fine net in one batched pass before the secant, which runs fine; f_pick is
// then the fine value. Outputs (t_pick, f_pick, t_min, z_secant).
//
// The TPU kernel sweeps the steps one after another in a loop carry over a
// 512-ray tile. Here the proposals of a ray are independent MLP evals that
// fill MLP tiles, and only the pick is sequential. The two fields take two
// block shapes:
//
// SIREN (siren.cuh's 64-row CUDA-core tile, 256 threads): a block takes 16
// rays, writes the 16 x n_steps proposal depths and values to shared
// memory, and one thread per ray scans its row in step order (`pick`). The
// re-validation is one 32-row tile, each secant step one 16-row tile; all of
// them go through one call of the tile, so it is compiled once per instance.
// 16 rays per block so that ~1-2k rays a training step still spread over the
// 132 SMs. Bound on an H100: operations, (n_steps + n_secant) SIREN evals
// per ray (~0.40 MFLOP each at 3x256) as three tf32 passes over the tf32
// peak (the least time for f32 products on the card); the bytes moved are
// 32 per ray in and 16 out.
//
// IGR (mlp_mma.cuh's 128-row tensor-core tile, 512 threads): a block takes
// kRays rays, and each sweep tile holds kRows / kRays consecutive steps of
// every one of them (row j * kRays + r: step j of ray r; a ragged last tile
// and the rays past n_rays are masked). After each sweep tile thread r < kRays
// folds its ray's new values, in step order, into a streaming pick (`fold`):
// the SIREN `pick`'s loop cut at tile boundaries, so no proposal buffer
// is needed and n_steps has no limit (the f32 tile leaves 15.9 KB of shared
// memory at H = 256, room for the proposals of ~16 rays). The sweep runs in
// the bf16 mode under `revalidate` (the coarse sweep) and otherwise in the
// fine mode; the re-validation tile (rows r: z_low of ray r, kRays + r: its
// t_pick) and each secant step's tile (row r: ray r) run in the fine mode
// (3xTF32, or bf16 for a bf16 callable). Every point goes through
// mlp_mma::tile(), which gives a row the same value as the fused IGR kernel
// does, so the sampler equals `sweep_plain` over the fused callables bit for
// bit. Bound on an H100: operations, n_steps bf16 evals per ray (one pass
// over the bf16 tensor-core peak) and 2 + n_secant fine evals (f32: three
// tf32 passes over the tf32 peak), ~0.40 MFLOP each at 4x256; the bytes
// moved are 32 per ray in and 16 out. What the design does about it: the
// sweep, ~90% of the FLOP, runs on the tensor cores in 128-row tiles that
// share each streamed weight chunk; the secant tiles are half empty at 64
// rays a block, the price of 384 blocks for the bench trace's 24,576 rays
// (three full waves on 132 SMs).
//
// t = t_lo + step * span and the points cam + t * dir are single-rounding
// fused multiply-adds (__fmaf_rn), as XLA forms them in the JAX package and
// as the plain PyTorch version forms them (utils.fma), so the proposals
// agree bit for bit and only the MLP arithmetic may differ.

#include <limits.h>

#include "mlp_mma.cuh"
#include "siren.cuh"

namespace {

__device__ __forceinline__ float eps_denom(float x, float eps) {
  const float a = fabsf(x);
  return (x < 0.f ? -1.f : 1.f) * (a < eps ? eps : a);
}

// -fl (zh - zl) / eps_denom(fh - fl, 1e-12) + zl, rounded step by step
__device__ __forceinline__ float z_pred(float fl, float fh, float zl, float zh) {
  const float num = __fmul_rn(-fl, __fsub_rn(zh, zl));
  return __fadd_rn(__fdiv_rn(num, eps_denom(__fsub_rn(fh, fl), 1e-12f)), zl);
}

constexpr size_t kSmemLimit = 232448;  // Hopper: 227 KB of dynamic shared memory per block

bool bad_args(int hidden, int n_rays, int n_steps, int n_secant, int limit) {
  return hidden % 32 != 0 || hidden < 32 || hidden > 256 || n_rays < 0 || n_steps < 1 ||
         n_steps > limit || n_secant < 0;
}

// ---------------------------------------------------------------------------
// SIREN: siren.cuh's CUDA-core tile, proposal buffers, one scan per ray
// ---------------------------------------------------------------------------

namespace siren_sweep {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kChunk = 32;
constexpr int kRaysPerBlock = 16;
static_assert(kRows == siren::kRows, "tile rows");
static_assert(kChunk == siren::kChunk, "tile chunk");

// One ray's pick (thread r < 16): scans its steps in order; writes the
// bracket (f_low, f_pick, z_low, t_pick) to its secant state and t_pick,
// f_pick, t_min to the outputs.
__device__ __forceinline__ void pick(int r, int nr, int r0, const float* tb, const float* fb,
                                     int n_steps, float margin, float* S, float* t_pick_out,
                                     float* f_pick_out, float* t_min_out) {
  const float* tr = tb + r * n_steps;
  const float* fr = fb + r * n_steps;
  float best = INFINITY, t_pick = 0.f, f_pick = 0.f, z_low = 0.f, f_low = 0.f;
  float prev_t = 0.f, prev_f = 0.f, f_min = INFINITY, t_min = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    const float ts = tr[s], fs = fr[s];
    const float v = __fadd_rn(fs, margin);
    const float sgn = isnan(v) ? NAN : (float)((v > 0.f) - (v < 0.f));
    const float cost = sgn * (float)(n_steps - s);
    const float pt = s == 0 ? ts : prev_t;
    const float pf = s == 0 ? fs : prev_f;
    if (cost < best) {
      best = cost;
      t_pick = ts;
      f_pick = fs;
      z_low = pt;
      f_low = pf;
    }
    if (fs < f_min) {
      f_min = fs;
      t_min = ts;
    }
    prev_t = ts;
    prev_f = fs;
  }
  S[0] = f_low;
  S[1] = f_pick;
  S[2] = z_low;
  S[3] = t_pick;
  if (r < nr) {
    t_pick_out[r0 + r] = t_pick;
    f_pick_out[r0 + r] = f_pick;
    t_min_out[r0 + r] = t_min;
  }
}

// Every MLP tile of a block goes through one loop with one call of the
// tile (inlined once per instance): first the sweep tiles on the sweep net,
// then, on the fine net, the re-validation tile (rows r = z_low, 16 + r =
// t_pick) when `revalidate`, then one 16-row tile per secant step.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(siren::Net sweep_net, siren::Net fine_net, int revalidate,
                 const float* __restrict__ cam, const float* __restrict__ dir,
                 const float* __restrict__ t_lo, const float* __restrict__ t_hi,
                 const float* __restrict__ steps, int n_rays, int n_steps, int n_secant,
                 float margin, float* __restrict__ t_pick_out, float* __restrict__ f_pick_out,
                 float* __restrict__ t_min_out, float* __restrict__ z_sec_out) {
  constexpr int H = NJ * 32;
  extern __shared__ float smem[];
  float* act = smem;
  float* wbuf = act + kRows * H;
  float* xs = wbuf + kChunk * H;          // (kRows, 3)
  float* vs = xs + kRows * 3;             // (kRows,)
  float* ray = vs + kRows;                // (16, 8): cam, dir, t_lo, span
  float* sec = ray + kRaysPerBlock * 8;   // (16, 5): fl, fh, zl, zh, z
  float* tb = sec + kRaysPerBlock * 5;    // (16, n_steps) proposal depths
  float* fb = tb + kRaysPerBlock * n_steps;  // (16, n_steps) proposal values

  const int r0 = blockIdx.x * kRaysPerBlock;
  const int nr = min(kRaysPerBlock, n_rays - r0);
  const int tid = threadIdx.x;
  if (tid < kRaysPerBlock) {
    const bool ok = tid < nr;
    const size_t g = (size_t)(r0 + tid);
    float* R = ray + tid * 8;
    for (int d = 0; d < 3; ++d) {
      R[d] = ok ? cam[g * 3 + d] : 0.f;
      R[3 + d] = ok ? dir[g * 3 + d] : 0.f;
    }
    const float lo = ok ? t_lo[g] : 0.f;
    const float hi = ok ? t_hi[g] : 0.f;
    R[6] = lo;
    R[7] = __fsub_rn(hi, lo);
  }
  __syncthreads();

  const int total = kRaysPerBlock * n_steps;
  const int n_sweep = (total + kRows - 1) / kRows;
  const int n_tiles = n_sweep + (revalidate ? 1 : 0) + n_secant;
  for (int it = 0; it < n_tiles; ++it) {
    const bool sweeping = it < n_sweep;
    const bool reval = revalidate && it == n_sweep;
    if (it == n_sweep) {  // the sweep is done: pick before the fine tiles
      if (tid < kRaysPerBlock)
        pick(tid, nr, r0, tb, fb, n_steps, margin, sec + tid * 5, t_pick_out, f_pick_out,
             t_min_out);
      __syncthreads();
    }
    // ---- the tile's points
    if (tid < kRows) {
      float p[3] = {0.f, 0.f, 0.f};
      if (sweeping) {
        const int q = it * kRows + tid;
        if (q < total) {
          const float* R = ray + (q / n_steps) * 8;
          const float t = __fmaf_rn(__ldg(steps + q % n_steps), R[7], R[6]);
          tb[q] = t;
          for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(t, R[3 + d], R[d]);
        }
      } else if (reval) {
        if (tid < 2 * kRaysPerBlock) {
          const int r = tid % kRaysPerBlock;
          const float z = sec[r * 5 + (tid < kRaysPerBlock ? 2 : 3)];
          const float* R = ray + r * 8;
          for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R[3 + d], R[d]);
        }
      } else if (tid < kRaysPerBlock) {
        float* S = sec + tid * 5;
        const float* R = ray + tid * 8;
        const float z = z_pred(S[0], S[1], S[2], S[3]);
        S[4] = z;
        for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R[3 + d], R[d]);
      }
      for (int d = 0; d < 3; ++d) xs[tid * 3 + d] = p[d];
    }
    __syncthreads();
    // the net by value: a reference to a kernel parameter chosen at run
    // time would make the tile read it through local memory
    const siren::Net net = sweeping ? sweep_net : fine_net;
    siren::tile<NJ, 1>(net, xs, act, wbuf, vs, nullptr);
    // ---- its values
    if (sweeping) {
      const int q = it * kRows + tid;
      if (tid < kRows && q < total) fb[q] = vs[tid];
    } else if (reval) {
      if (tid < kRaysPerBlock) {
        sec[tid * 5 + 0] = vs[tid];
        sec[tid * 5 + 1] = vs[kRaysPerBlock + tid];
        if (tid < nr) f_pick_out[r0 + tid] = vs[kRaysPerBlock + tid];  // fine f_pick
      }
    } else if (tid < kRaysPerBlock) {
      float* S = sec + tid * 5;
      const float f_mid = vs[tid];
      if (f_mid > 0.f) {
        S[0] = f_mid;
        S[2] = S[4];
      }
      if (f_mid < 0.f) {
        S[1] = f_mid;
        S[3] = S[4];
      }
    }
    __syncthreads();
  }
  if (n_tiles == n_sweep) {  // no fine tiles: pick after the sweep
    if (tid < kRaysPerBlock)
      pick(tid, nr, r0, tb, fb, n_steps, margin, sec + tid * 5, t_pick_out, f_pick_out,
             t_min_out);
    __syncthreads();
  }
  if (tid < nr) {
    const float* S = sec + tid * 5;
    z_sec_out[r0 + tid] = z_pred(S[0], S[1], S[2], S[3]);
  }
}

// the tile (activations + one weight chunk), its points and values, the
// per-ray state and the two proposal buffers
size_t smem_bytes(int hidden, int n_steps) {
  return sizeof(float) * ((size_t)siren::tile_smem_floats(hidden) + kRows * 3 + kRows +
                          kRaysPerBlock * (8 + 5) + (size_t)2 * kRaysPerBlock * n_steps);
}

int max_steps(int hidden) {
  const size_t fixed = smem_bytes(hidden, 0);
  return fixed >= kSmemLimit ? 0
                             : (int)((kSmemLimit - fixed) / (sizeof(float) * 2 * kRaysPerBlock));
}

template <int NJ>
int launch(const siren::Net& net, const float* cam, const float* dir, const float* t_lo,
           const float* t_hi, const float* steps, int n_rays, int n_steps, int n_secant,
           float margin, float* t_pick, float* f_pick, float* t_min, float* z_sec,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(NJ * 32, n_steps);
  cudaError_t err = cudaFuncSetAttribute(sweep_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  sweep_kernel<NJ><<<blocks, kThreads, smem, stream>>>(net, net, 0, cam, dir, t_lo, t_hi, steps,
                                                       n_rays, n_steps, n_secant, margin, t_pick,
                                                       f_pick, t_min, z_sec);
  return (int)cudaGetLastError();
}

}  // namespace siren_sweep

// ---------------------------------------------------------------------------
// IGR: mlp_mma.cuh's tensor-core tile, a streaming pick
// ---------------------------------------------------------------------------

namespace igr_sweep {

using mlp_mma::Bf16Mode;
using mlp_mma::kRows;
using mlp_mma::kThreads;
using mlp_mma::Net;
using mlp_mma::Tf32x3Mode;

// rays per block: 64 took 18.4 ms at the bench trace's sampler shape on an
// H100, 32 took 23.6 and 128 took 20.8 (PERF.md)
constexpr int kRays = 64;
static_assert(kRays <= kRows && kRows % kRays == 0, "a sweep tile holds whole steps");
constexpr int kSteps = kRows / kRays;  // steps of each ray per sweep tile

// A ray's streaming pick: the TPU kernel's carry (and `pick` above), the
// argmin of sign(f + margin) * (n_steps - s) and the argmin of f, one step at
// a time. A step wins where it is strictly below the best so far, so the
// first minimum is kept and a NaN step never wins (sign(NaN) is NaN).
struct Pick {
  float best, t_pick, f_pick, z_low, f_low, prev_t, prev_f, f_min, t_min;
};
constexpr int kPickFloats = 9;

// ray r's pick from / to its column of the (kPickFloats, kRays) array
__device__ __forceinline__ Pick load_pick(const float* pk, int r) {
  return Pick{pk[r],             pk[kRays + r],     pk[2 * kRays + r],
              pk[3 * kRays + r], pk[4 * kRays + r], pk[5 * kRays + r],
              pk[6 * kRays + r], pk[7 * kRays + r], pk[8 * kRays + r]};
}

__device__ __forceinline__ void store_pick(float* pk, int r, const Pick& k) {
  const float f[kPickFloats] = {k.best,   k.t_pick, k.f_pick, k.z_low, k.f_low,
                                k.prev_t, k.prev_f, k.f_min,  k.t_min};
#pragma unroll
  for (int i = 0; i < kPickFloats; ++i) pk[i * kRays + r] = f[i];
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
// [field][kRays]) its geometry (cam, dir, t_lo, span), its pick and its
// secant state (fl, fh, zl, zh, z).
constexpr int kRayFloats = 8 + kPickFloats + 5;

template <int H>
__host__ __device__ constexpr int act_bytes() {
  return kRows * mlp_mma::pitch_a<Tf32x3Mode>(H);
}

template <int H>
constexpr int smem_bytes() {
  return act_bytes<H>() + 2 * mlp_mma::stage_bytes<Tf32x3Mode>(H) +
         4 * (kRows * 3 + kRows + kRays * kRayFloats);
}

// Every tile of a block goes through one loop with one call of the tile per
// mode: the sweep tiles (sweep net), the re-validation tiles when
// `revalidate`, then the secant tiles (fine net).
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    sweep_kernel(Net sweep_net, Net fine_net, int sweep_bf16, int fine_bf16, int revalidate,
                 const float* __restrict__ cam, const float* __restrict__ dir,
                 const float* __restrict__ t_lo, const float* __restrict__ t_hi,
                 const float* __restrict__ steps, int n_rays, int n_steps, int n_secant,
                 float margin, float* __restrict__ t_pick_out, float* __restrict__ f_pick_out,
                 float* __restrict__ t_min_out, float* __restrict__ z_sec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* act = smem;
  unsigned char* wbuf = act + act_bytes<H>();
  float* xs = reinterpret_cast<float*>(wbuf + 2 * mlp_mma::stage_bytes<Tf32x3Mode>(H));
  float* vs = xs + kRows * 3;         // (kRows,)
  float* ray = vs + kRows;            // (8, kRays): cam xyz, dir xyz, t_lo, span
  float* pk = ray + 8 * kRays;        // (kPickFloats, kRays)
  float* sec = pk + kPickFloats * kRays;  // (5, kRays): fl, fh, zl, zh, z
  auto R = [&](int f, int r) -> float& { return ray[f * kRays + r]; };
  auto S = [&](int f, int r) -> float& { return sec[f * kRays + r]; };

  const int r0 = blockIdx.x * kRays;
  const int nr = min(kRays, n_rays - r0);
  const int tid = threadIdx.x;
  if (tid < kRays) {  // masked rays sit at the origin with t = 0
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
    store_pick(pk, tid, Pick{INFINITY, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, INFINITY, 0.f});
  }
  __syncthreads();  // every row's thread reads its ray's geometry
  // the point at depth z on ray r
  auto point = [&](int r, float z, float* p) {
    for (int d = 0; d < 3; ++d) p[d] = __fmaf_rn(z, R(3 + d, r), R(d, r));
  };
  // thread r < kRays: the pick is done; the outputs, and the bracket as the
  // secant state
  auto finish_pick = [&]() {
    if (tid < kRays) {
      const Pick k = load_pick(pk, tid);
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

  const int n_sweep = (n_steps + kSteps - 1) / kSteps;
  const int n_reval = revalidate ? (2 * kRays + kRows - 1) / kRows : 0;
  const int per_secant = (kRays + kRows - 1) / kRows;
  const int n_tiles = n_sweep + n_reval + n_secant * per_secant;
  for (int it = 0; it < n_tiles; ++it) {
    const bool sweeping = it < n_sweep;
    const bool reval = !sweeping && it < n_sweep + n_reval;
    // the first row of this fine tile in its phase's row list
    const int base = (reval ? it - n_sweep : (it - n_sweep - n_reval) % per_secant) * kRows;
    if (it == n_sweep) finish_pick();
    // ---- the tile's points (thread q < kRows: row q)
    if (tid < kRows) {
      float p[3] = {0.f, 0.f, 0.f};
      if (sweeping) {
        const int j = tid / kRays, r = tid - j * kRays;
        const int s = it * kSteps + j;
        if (s < n_steps && r < nr) point(r, __fmaf_rn(__ldg(steps + s), R(7, r), R(6, r)), p);
      } else if (reval) {  // rows r: z_low of ray r; kRays + r: its t_pick
        const int q = base + tid;
        if (q < 2 * kRays) point(q % kRays, S(q < kRays ? 2 : 3, q % kRays), p);
      } else {
        const int r = base + tid;
        if (r < kRays) {
          const float z = z_pred(S(0, r), S(1, r), S(2, r), S(3, r));
          S(4, r) = z;
          point(r, z, p);
        }
      }
      for (int d = 0; d < 3; ++d) xs[tid * 3 + d] = p[d];
    }
    // the net by value: a reference to a kernel parameter chosen at run
    // time would make the tile read it through local memory
    const Net net = sweeping ? sweep_net : fine_net;
    if (sweeping ? sweep_bf16 : fine_bf16)
      mlp_mma::tile<Bf16Mode, H, 1>(net, xs, act, wbuf, 0, kRows, vs, nullptr);
    else
      mlp_mma::tile<Tf32x3Mode, H, 1>(net, xs, act, wbuf, 0, kRows, vs, nullptr);
    // ---- its values
    if (sweeping) {
      if (tid < kRays) {
        Pick k = load_pick(pk, tid);
        for (int j = 0; j < kSteps; ++j) {
          const int s = it * kSteps + j;
          if (s < n_steps)
            fold(k, s, n_steps, __fmaf_rn(__ldg(steps + s), R(7, tid), R(6, tid)),
                 vs[j * kRays + tid], margin);
        }
        store_pick(pk, tid, k);
      }
    } else if (reval) {
      const int q = base + tid;
      if (tid < kRows && q < 2 * kRays) {
        const int r = q % kRays;
        S(q < kRays ? 0 : 1, r) = vs[tid];
        if (q >= kRays && r < nr) f_pick_out[r0 + r] = vs[tid];  // fine f_pick
      }
    } else {
      const int r = base + tid;
      if (tid < kRows && r < kRays) {
        const float f_mid = vs[tid];
        if (f_mid > 0.f) {
          S(0, r) = f_mid;
          S(2, r) = S(4, r);
        }
        if (f_mid < 0.f) {
          S(1, r) = f_mid;
          S(3, r) = S(4, r);
        }
      }
    }
    __syncthreads();  // the secant state of every ray visible to the next tile's rows
  }
  if (n_tiles == n_sweep) finish_pick();  // no fine tiles
  if (tid < nr) z_sec_out[r0 + tid] = z_pred(S(0, tid), S(1, tid), S(2, tid), S(3, tid));
}

template <int H>
int launch(const Net& sweep, const Net& fine, int sweep_bf16, int fine_bf16, int revalidate,
           const float* cam, const float* dir, const float* t_lo, const float* t_hi,
           const float* steps, int n_rays, int n_steps, int n_secant, float margin,
           float* t_pick, float* f_pick, float* t_min, float* z_sec, cudaStream_t stream) {
  constexpr int smem = smem_bytes<H>();
  static_assert(smem <= (int)kSmemLimit, "the sampler exceeds a block's shared memory");
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (n_rays + kRays - 1) / kRays;
  sweep_kernel<H><<<blocks, kThreads, smem, stream>>>(
      sweep, fine, sweep_bf16, fine_bf16, revalidate, cam, dir, t_lo, t_hi, steps, n_rays,
      n_steps, n_secant, margin, t_pick, f_pick, t_min, z_sec);
  return (int)cudaGetLastError();
}

}  // namespace igr_sweep

}  // namespace

// Largest n_steps whose proposal buffers fit next to the SIREN tile (the
// IGR sampler keeps no proposal buffer and takes any n_steps >= 1).
extern "C" int sampler_max_steps(int hidden) { return siren_sweep::max_steps(hidden); }

// cam, dir (n_rays, 3); t_lo, t_hi (n_rays,); steps (n_steps,) fractions of
// [t_lo, t_hi] -> t_pick, f_pick, t_min, z_secant (n_rays,) each, on the
// SIREN net (fine sweep only).
extern "C" int sampler_sweep(const float* cam, const float* dir, const float* t_lo,
                             const float* t_hi, const float* steps, int n_rays, int n_steps,
                             int n_secant, float margin, const float* w0, const float* b0,
                             const float* wh_t, const float* bh, const float* wout,
                             const float* bout, int hidden, int n_hidden, float omega_first,
                             float omega_hidden, float* t_pick, float* f_pick, float* t_min,
                             float* z_sec, void* stream) {
  if (bad_args(hidden, n_rays, n_steps, n_secant, sampler_max_steps(hidden)) || n_hidden < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const siren::Net net{w0, b0, wh_t, bh, wout, bout, n_hidden, omega_first, omega_hidden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden / 32) {
#define CASE(NJ)                                                                              \
  case NJ:                                                                                    \
    return siren_sweep::launch<NJ>(net, cam, dir, t_lo, t_hi, steps, n_rays, n_steps,         \
                                   n_secant, margin, t_pick, f_pick, t_min, z_sec, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same on the IGR net, on the tensor-core tile. `sw` and `fw` are the
// seven pointers of mlp_mma::Net (w0, b0, wh, wh_lo, bh, wout, bout) of the
// sweep and the fine net, `sweep_bf16` and `fine_bf16` their modes (bf16, or
// f32 as 3xTF32 with wh_lo the tf32 lo part); `revalidate` evaluates the
// bracket ends again on the fine net before the secant (the coarse sweep).
extern "C" int sampler_sweep_igr(const float* cam, const float* dir, const float* t_lo,
                                 const float* t_hi, const float* steps, int n_rays, int n_steps,
                                 int n_secant, float margin, int revalidate,
                                 const void* const* sw, const void* const* fw, int hidden,
                                 int n_hidden, unsigned skip, int final_tanh, int sweep_bf16,
                                 int fine_bf16, float* t_pick, float* f_pick, float* t_min,
                                 float* z_sec, void* stream) {
  if (bad_args(hidden, n_rays, n_steps, n_secant, INT_MAX) || n_hidden < 0 || (skip & 1u) ||
      (n_hidden > 0 && (sw[2] == nullptr || fw[2] == nullptr ||
                        (!sweep_bf16 && sw[3] == nullptr) || (!fine_bf16 && fw[3] == nullptr))))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  auto net = [&](const void* const* w) {
    return mlp_mma::Net{static_cast<const float*>(w[0]), static_cast<const float*>(w[1]),
                        w[2],
                        w[3],
                        static_cast<const float*>(w[4]),
                        static_cast<const float*>(w[5]),
                        static_cast<const float*>(w[6]),
                        n_hidden,
                        skip,
                        final_tanh};
  };
  const mlp_mma::Net sweep = net(sw), fine = net(fw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hidden / 32) {
#define CASE(NJ)                                                                              \
  case NJ:                                                                                    \
    return igr_sweep::launch<NJ * 32>(sweep, fine, sweep_bf16, fine_bf16, revalidate, cam,    \
                                      dir, t_lo, t_hi, steps, n_rays, n_steps, n_secant,      \
                                      margin, t_pick, f_pick, t_min, z_sec, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
