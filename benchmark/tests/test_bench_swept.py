"""sampler_swept_pct.render, the share of the sampler's slots that its
kernel swept, read from the program's `sampler.swept` and `sampler.slots`.

- On a synthetic snapshot: the ratio; None without `sampler.swept` (a
  program whose kernel sweeps every slot keeps none) or without slots.
- A traced run of the IGR cell on the CPU at a tiny size (the harness's
  plain route, which computes every slot): the reading is the ratio of the
  run's two counters, 100.
- On the card, a traced run of each cell: the kernel sweeps the filled
  slots' tiles only, so the reading lies within the live share and 100.
  Skips without CUDA.

    python -m pytest --noconftest -o addopts="" benchmark/tests/test_bench_swept.py
"""

import pytest
import torch

from benchmark import harness, spec
from isopoints_torch import tracing

SIREN = "siren-3x256.render512x2"
IGR = "igr-8x512.render256x4"
METRIC = "sampler_swept_pct.render"
SEED = 3_000_000_019
TINY = {"mix": {"image_size": 16, "rays_per_chunk": 256},
        "fit": {"steps": 40, "points": 2048},
        "check": {"requests": 1, "rays": 256}}


def _read(monkeypatch, counters):
    snap = {"spans": [], "counters": counters, "launches": []}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    return spec.Cell(IGR).reader(METRIC)({})


@pytest.mark.parametrize("counters,want", [
    ({"sampler.slots": 48, "sampler.live": 5, "sampler.swept": 12}, 25.0),
    ({"sampler.slots": 48, "sampler.live": 5}, None),
    ({"sampler.swept": 0}, None),
    ({}, None)])
def test_reader(monkeypatch, counters, want):
    got = _read(monkeypatch, counters)
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


def _traced(cell, device, overrides=None):
    seen = {}
    snapshot = tracing.snapshot

    def keep():
        snap = snapshot()
        seen.update(snap["counters"])
        return snap

    tracing.snapshot, saved = keep, tracing.snapshot
    try:
        res = harness.run(cell, SEED, 0.0, True, device, overrides=overrides)[0]
    finally:
        tracing.snapshot = saved
    return res, seen


def test_traced_cpu_run_reads_the_counters():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res, c = _traced(IGR, "cpu", TINY)
    finally:
        torch.set_num_threads(n)
    got = res["metrics"][METRIC]["value"]
    assert got == pytest.approx(100.0 * c["sampler.swept"] / c["sampler.slots"])
    assert got == pytest.approx(100.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [SIREN, IGR])
def test_traced_card_run_sweeps_the_filled_tiles(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res, c = _traced(cell, "cuda", {"fit": {"steps": 50}})
    got = res["metrics"][METRIC]["value"]
    live = res["metrics"]["sampler_live_pct.render"]["value"]
    assert live <= got < 100.0
    assert got == pytest.approx(100.0 * c["sampler.swept"] / c["sampler.slots"])
