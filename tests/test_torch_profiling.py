"""Port parity: the roofline accounting (isopoints_torch/utils/profiling.py
and `bench.trace_roofline`) against the JAX package's utils/profiling.py
and bench.py:186-216, on the CPU.

- `mlp_eval_roofline`'s FLOP and byte counts equal JAX's exactly, with and
  without the input gradient, fused and not.
- The peaks are one H100 SXM's (PERF.md §2), not the TPU's: the f32
  product rate is three tf32 passes over 495 TFLOP/s; the speed-of-light
  time and the bound follow from them.
- `trace_roofline` counts bench.py's MLP evaluations for its schedule (and
  for a schedule without compaction or fused backstep) exactly as JAX's
  bench does.
"""

import numpy as np
import pytest

from isopoints_tpu.models.raytracing import RayTracingConfig as JCfg
from isopoints_tpu.utils import profiling as jp
from isopoints_torch import bench
from isopoints_torch.utils import profiling as tp


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_counts_match_jax(with_grad, fused):
    dims = [3, 256, 256, 256, 1]
    j = jp.mlp_eval_roofline("x", 123_457, dims, 0.002, with_grad=with_grad, fused=fused)
    t = tp.mlp_eval_roofline("x", 123_457, dims, 0.002, with_grad=with_grad, fused=fused)
    assert t.flops == j.flops and t.hbm_bytes == j.hbm_bytes
    assert t.achieved_flops == j.achieved_flops and t.achieved_bw == j.achieved_bw


def test_h100_peaks():
    assert tp.PEAK_BF16_FLOPS == 989e12
    assert tp.PEAK_F32_MMA_FLOPS == 165e12
    assert tp.PEAK_F32_FLOPS == 67e12
    assert tp.PEAK_HBM_BYTES == 3.35e12
    assert jp.PEAK_HBM_BYTES != tp.PEAK_HBM_BYTES   # not the TPU's
    rl = tp.mlp_eval_roofline("x", 1_000_000, [3, 256, 256, 1], 1e-3)
    u = rl.utilization()
    assert u["bound"] == "compute"
    np.testing.assert_allclose(u["sol_seconds"], rl.flops / 165e12, rtol=1e-12)
    np.testing.assert_allclose(u["flop_util"], rl.flops / 1e-3 / 165e12, rtol=1e-12)
    assert tp.KernelRoofline("m", 1.0, 3.35e12, 2.0).utilization()["bound"] == "memory"
    assert "165 TFLOP/s" in rl.report() and "3.35 TB/s" in rl.report()


def jax_bench_evals(cfg, n_rays):
    """bench.py:193-212's count, as it stands there."""
    lsi = 1 + cfg.line_step_iters
    lsi_fine = 1 if cfg.fused_backstep else lsi
    stages = cfg.trace_compact_after
    stages = (stages,) if isinstance(stages, int) and stages > 0 else \
        (stages if isinstance(stages, tuple) else ())
    fr = cfg.trace_compact_fraction
    fr = (fr,) * len(stages) if isinstance(fr, float) else fr
    full_end = stages[0] if stages else cfg.sphere_tracing_iters
    lsi_coarse = 1 if cfg.coarse_stall_on_cross else lsi
    evals_per_ray = 2.0 * (full_end + 1) * lsi_coarse
    bounds = list(stages[1:]) + [cfg.sphere_tracing_iters]
    for a, nxt, f in zip(stages, bounds, fr):
        evals_per_ray += 2.0 * (nxt - a) * lsi_fine * f
    evals_per_ray += cfg.sampler_fraction * (cfg.n_steps + cfg.n_secant_steps)
    return int(n_rays * evals_per_ray)


@pytest.mark.parametrize("schedule", ["bench", "plain"])
def test_trace_roofline_counts(schedule):
    kw = bench.BENCH_SCHEDULE if schedule == "bench" else {}
    tcfg = bench.RayTracingConfig(**kw)
    jcfg = JCfg(**kw)
    rl = bench.trace_roofline(tcfg, bench.N_RAYS, 100.0)
    want = jp.mlp_eval_roofline("sphere_trace_mlp", jax_bench_evals(jcfg, bench.N_RAYS),
                                [3, 256, 256, 256, 256, 1], 0.1)
    assert rl.flops == want.flops and rl.hbm_bytes == want.hbm_bytes
    assert rl.seconds == 0.1
