"""The per-layer metrics that read the program's spans and counters
(isopoints_torch/tracing.py), and the program's launch records against the
launch hook (trace.launch_hook).

- Each reader gives the hand-computed value on a synthetic ctx and
  snapshot, and None on an empty snapshot (CPU).
- On the card, one request of each cell's configuration under a profiler
  with the hook: the program's records of the MLP and sampler wrappers
  equal the hook's, field for field and in order, so both roofline
  metrics can read the program's records with no change in value; the
  four metrics read numbers. Skips without CUDA.

    python -m pytest --noconftest -o addopts="" benchmark/tests/test_bench_tracing.py
"""

import math

import pytest
import torch

from benchmark import spec
from isopoints_torch import tracing

SIREN = "siren-3x256.render512x2"
IGR = "igr-8x512.render256x4"
METRICS = ("host_syncs_per_chunk.render", "trace_idle_pct.render",
           "mlp_live_pct.render", "sampler_live_pct.render")


def _read(metric, monkeypatch, snap, ctx):
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    return spec.Cell(SIREN).reader(metric)(ctx)


SNAP = {
    "spans": [{"name": "render.trace", "start_ns": 0, "end_ns": 100},
              {"name": "render.shade", "start_ns": 100, "end_ns": 200},
              {"name": "render.trace", "start_ns": 200, "end_ns": 300}],
    "counters": {"host_syncs.loop": 40, "host_syncs.readback": 2,
                 "host_syncs.copy": 4, "render.chunks": 2,
                 "mlp.points.march": 100, "mlp.points.buffer": 50,
                 "mlp.points.shade": 50, "mlp.live.march": 30,
                 "mlp.live.buffer": 20, "mlp.live.shade": 10,
                 "sampler.slots": 48, "sampler.live": 12},
    "launches": []}
CTX = {"window_s": 1e-6,
       "device_events": [("k", 10, 30), ("k", 20, 50), ("k", 90, 210),
                         ("k", 250, 260), ("k", 400, 500)]}


@pytest.mark.parametrize("metric,want", [
    ("host_syncs_per_chunk.render", (40 + 2 + 4) / 2),
    # [0, 100]: busy 10-50 and 90-100, idle 50; [200, 300]: busy 200-210
    # and 250-260, idle 80; over a 1000 ns window
    ("trace_idle_pct.render", 13.0),
    ("mlp_live_pct.render", 100.0 * 60 / 200),
    ("sampler_live_pct.render", 25.0)])
def test_readers(metric, want, monkeypatch):
    assert _read(metric, monkeypatch, SNAP, CTX) == pytest.approx(want, rel=1e-12)
    empty = {"spans": [], "counters": {}, "launches": []}
    assert _read(metric, monkeypatch, empty, CTX) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [SIREN, IGR])
def test_launch_records_equal_the_hook(card, cell):
    """One request (the weights fitted 50 steps) under a profiler with the
    hook: the program's MLP and sampler launch records equal the hook's,
    and the metrics that read the program's spans and counters read
    numbers."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import harness, trace

    kinds = {"fused_mlp": "mlp", "fused_igr": "mlp", "fused_sampler": "sampler"}
    c = spec.Cell(cell)
    s = harness.Setup(c, 2147483659, card, {"fit": {"steps": 50}})
    s.request(-1)
    hook = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.launch_hook(hook), record_function(trace.WINDOW):
            s.request(0)
        torch.cuda.synchronize()
    snap = tracing.snapshot()
    mine = [dict(r, kernel=kinds[r["kernel"]]) for r in snap["launches"]
            if r["kernel"] in kinds]
    assert len(hook) > 0 and mine == hook
    summ = trace.summarise(prof)
    ctx = {"window_s": summ["window_s"], "busy_s": summ["busy_s"],
           "device_events": summ["device_events"]}
    for m in METRICS:
        v = c.reader(m)(ctx)
        assert v is not None and math.isfinite(v) and v > 0, m
        assert m.startswith("host_syncs") or v <= 100, m
