"""The port's spans and counters (isopoints_torch/tracing.py) on the CPU.

- Off (no profiler recording), nothing is recorded, no
  `record_function` is entered and a render leaves the log empty; the
  launch counter still counts.
- Spans nest, with parent links, and the spans of one
  `Generator.raytrace_images` share one request id; a new profiler session
  clears the log; each span's interval encloses its profiler event, within
  1 ms at both ends.
- A SIREN 3x256 of the MVR ablation's config (configs/
  ablation_compound_uni_dir.yml), fitted a few steps to a torus and
  rendered at 24 px on the plain route: `host_syncs.loop` equals the exit
  tests counted by wrapping `_run_loop` and the loop bodies,
  `sampler.slots` and `sampler.live` equal the sampler's buffer and mask,
  and `mlp.points.*` and `mlp.live.*` equal a recount from the loop
  states and the trace's masks; so on the in-kernel march (its fixed
  count over the stage's buffer, the rays unfinished on entry) and with
  the sampler on every ray (`sampler_fraction` 1). A traced render gives
  the untraced one's pixels.
- Under capacities small enough to spill (trace stages at 0.3 and 0.12 of
  a chunk, the sampler at 0.05), the render's compactions grow: overflow
  0, `trace.grown` counts the rays past the static capacities, and the
  image and each chunk's hits and depths equal the render with every
  fraction 1 (within PR 13's hit-depth 1e-4 and RGB 1e-3; on this field
  they are equal); the same trace without `grow` spills.
- Device counters keep their sums across the folds of partial sums;
  `tracing.union` counts overlaps once; `train_mvr --profile-at`'s
  exporter writes the spans beside the trace.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isopoints_torch import tracing
from isopoints_torch.models import generator, raytracing
from isopoints_torch.ops import _build, fused_trace

CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "isopoints_torch", "configs",
                      "ablation_compound_uni_dir.yml")


def _torus(x):
    q = torch.stack([torch.linalg.norm(x[..., :2], dim=-1) - 0.55, x[..., 2]], -1)
    return torch.linalg.norm(q, dim=-1) - 0.16


class _Renderer:
    """The config's model with its decoder fitted to a torus, and a
    Generator at 24 px in one chunk a view pair."""

    def __init__(self):
        from isopoints_torch.config import default_config_path, load_config
        from isopoints_torch.factories import create_model

        cfg = load_config(CONFIG, default_config_path())
        self.model = create_model(cfg, generator=torch.Generator().manual_seed(0),
                                  device="cpu")
        g = torch.Generator().manual_seed(1)
        dec = self.model.decoder
        opt = torch.optim.Adam(dec.parameters(), lr=5e-4)
        for _ in range(150):
            x = torch.rand((4096, 3), generator=g) * 2.2 - 1.1
            loss = torch.mean(torch.abs(dec(x) - _torus(x)))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        for p in dec.parameters():
            p.requires_grad_(False)
        self.gen = generator.Generator(self.model, generator.GeneratorConfig(
            image_size=24, rays_per_chunk=576))

    def request(self, i: int) -> np.ndarray:
        """RGBA of two views 180 degrees apart, 15 degrees up."""
        from isopoints_torch.core.camera import (PerspectiveCamera,
                                                 look_at_view_transform)

        R, T = look_at_view_transform(2.0, 15.0,
                                      37.0 * i + torch.tensor([0.0, 180.0]))
        cam = PerspectiveCamera.create(R=R, T=T, focal_length=2.0)
        return self.gen.raytrace_images(cam)


@pytest.fixture(scope="module")
def setup():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    s = _Renderer()
    s.request(-1)
    yield s
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing(setup, monkeypatch):
    def no_record(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    with _cpu_profile():
        with tracing.span("x"):
            pass
    assert tracing.snapshot()["spans"]
    monkeypatch.setattr(torch.profiler, "record_function", no_record)
    assert not tracing.on()
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        tracing.count("c", 3)
        tracing.count_device("d", torch.ones(4, dtype=torch.bool))
    k = _build.LaunchCount("k")
    k.launch(7, mode=1)
    assert k.launches == 1
    setup.request(0)
    # the log still holds the last session, untouched by calls while off
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["x"]
    assert snap["counters"] == {} and snap["launches"] == []
    tracing.reset()
    setup.request(1)
    assert tracing.snapshot() == {"spans": [], "counters": {}, "launches": []}


def test_spans_nest_with_one_request_id_a_render(setup):
    with _cpu_profile():
        setup.request(0)
        setup.request(1)
        with tracing.span("outside"):
            pass
    spans = tracing.snapshot()["spans"]
    by_name = lambda n: [s for s in spans if s["name"] == n]
    parent = lambda s: spans[s["parent"]]["name"] if s["parent"] is not None else None
    reqs = by_name("render.request")
    assert [r["request"] for r in reqs] == [1, 2]
    assert all(r["parent"] is None for r in reqs)
    assert by_name("outside")[0]["request"] is None
    want = {"render.chunk": "render.request", "render.readback": "render.request",
            "render.trace": "render.chunk", "render.shade": "render.chunk",
            "trace.coarse": "render.trace", "trace.revalidate": "render.trace",
            "trace.full": "render.trace", "trace.stage1": "render.trace",
            "trace.stage2": "render.trace", "trace.unwind": "render.trace",
            "trace.sampler": "render.trace"}
    for name, p in want.items():
        got = by_name(name)
        assert len(got) == 2, name          # one chunk a request at 24 px
        assert all(parent(s) == p for s in got), name
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
            assert s["request"] == p["request"]
    # one request's spans share its id
    ids = {s["request"] for s in spans if s["name"].startswith(("trace.", "render."))}
    assert ids == {1, 2}


def test_span_encloses_its_profiler_event():
    names = [f"probe.{i}" for i in range(6)]
    with _cpu_profile() as prof:
        with tracing.span("probe.outer"):
            for n in names:
                with tracing.span(n):
                    torch.ones(64).cumsum(0)
    spans = {s["name"]: s for s in tracing.snapshot()["spans"]}
    events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert set(events) == set(spans) == set(names) | {"probe.outer"}
    for n, (a, b) in events.items():
        s = spans[n]
        assert s["start_ns"] <= a <= b <= s["end_ns"], n
        assert a - s["start_ns"] < 1_000_000 and s["end_ns"] - b < 1_000_000, n


def test_new_session_clears_the_log():
    with _cpu_profile():
        with tracing.span("first"):
            tracing.count("n", 2)
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["first"]
    assert snap["counters"] == {"n": 2}
    with _cpu_profile():
        with tracing.span("second"):
            tracing.count_device("m", torch.tensor([True, False, True]), 2)
    snap = tracing.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["second"]
    assert snap["counters"] == {"m": 4}


def test_launch_records_while_on():
    k = _build.LaunchCount("probe_kernel")
    with _cpu_profile():
        k.launch(5, with_grad=True)
        k.launch(9)
    k.launch(3)
    assert k.launches == 3
    assert tracing.snapshot()["launches"] == [
        {"kernel": "probe_kernel", "n": 5, "with_grad": True},
        {"kernel": "probe_kernel", "n": 9}]


@pytest.mark.parametrize("route", ["plain", "in_kernel", "dense_sampler"])
def test_render_counters_match_recounts(setup, monkeypatch, route):
    rt = setup.gen.render_cfg()
    if route == "in_kernel":
        rt = dataclasses.replace(rt, trace_in_kernel=True)
    elif route == "dense_sampler":
        rt = dataclasses.replace(rt, sampler_fraction=1.0)
    monkeypatch.setattr(setup.gen, "render_cfg", lambda: rt)
    tests, iters, stepped, inside = [0], [0], [0], [False]
    live = {"march": 0, "buffer": 0, "shade": 0}
    points = {"march": 0}

    def body(orig, evals):
        def f(st, *a, **k):
            if not inside[0]:
                iters[0] += 1
                live["march"] += 2 * evals * int((st[4] | st[5]).sum())
                points["march"] += 2 * evals * st[4].numel()
            return orig(st, *a, **k)
        return f

    for name, evals in (("_body_stall", 1), ("body_fused", 1),
                        ("_body", 1 + rt.line_step_iters)):
        monkeypatch.setattr(raytracing, name, body(getattr(raytracing, name), evals))
    orig_loop = raytracing._run_loop

    def run_loop(st, eval_pair, start_it, max_iters, *a, **k):
        iters[0] = 0
        out = orig_loop(st, eval_pair, start_it, max_iters, *a, **k)
        tests[0] += iters[0] + (start_it + iters[0] < max_iters)
        return out

    monkeypatch.setattr(raytracing, "_run_loop", run_loop)
    orig_step = fused_trace.TraceStepper.__call__

    def step(self, cam, dirs, state10, n_iters, *a):
        # the in-kernel march: a fixed count over the whole buffer
        stepped[0] += 1
        live["march"] += 2 * n_iters * int((state10[4] | state10[5]).sum())
        points["march"] += 2 * n_iters * state10[4].numel()
        inside[0] = True
        try:
            return orig_step(self, cam, dirs, state10, n_iters, *a)
        finally:
            inside[0] = False

    monkeypatch.setattr(fused_trace.TraceStepper, "__call__", step)
    results = []
    orig_trace = generator.ray_trace

    def ray_trace(*a, **k):
        res = orig_trace(*a, **k)
        results.append(res)
        return res

    monkeypatch.setattr(generator, "ray_trace", ray_trace)
    with _cpu_profile():
        setup.request(0)
        setup.request(1)
    c = tracing.snapshot()["counters"]
    assert len(results) == c["render.chunks"] == 2
    assert c["host_syncs.loop"] == tests[0] > 0
    assert c["host_syncs.readback"] == 4
    assert "host_syncs.copy" not in c                 # no copy to a card
    assert stepped[0] == (2 * 2 if route == "in_kernel" else 0)
    b, n = results[0].sampler_mask.shape
    assert c["sampler.slots"] == 2 * b * math.ceil(n * rt.sampler_fraction)
    for r in results:
        assert int(r.sampler_overflow) == 0
        # two whole-buffer pair evaluations: the coarse phase's first and
        # the fine re-validation; the stages (8, 12) run fine after it
        live["buffer"] += 2 * 2 * int(r.mask_intersect.sum())
        live["shade"] += int(r.network_object_mask.sum())
    assert c["sampler.live"] == sum(int(r.sampler_mask.sum()) for r in results) > 0
    for site, v in live.items():
        assert c[f"mlp.live.{site}"] == v > 0, site
    assert c["mlp.points.march"] == points["march"]
    assert c["mlp.points.buffer"] == 2 * 2 * 2 * b * n
    assert c["mlp.points.shade"] == 2 * b * n
    assert c["mlp.live.march"] < c["mlp.points.march"]


def test_grown_render_leaves_no_ray_out(setup, monkeypatch):
    rt = setup.gen.render_cfg()
    small = dataclasses.replace(rt, trace_compact_fraction=(0.3, 0.12),
                                sampler_fraction=0.05)
    whole = dataclasses.replace(rt, trace_compact_fraction=(1.0, 1.0),
                                sampler_fraction=1.0)
    results, grow = [], [True]
    orig_trace = generator.ray_trace

    def ray_trace(*a, **k):
        res = orig_trace(*a, **dict(k, grow=grow[0]))
        results.append(res)
        return res

    monkeypatch.setattr(generator, "ray_trace", ray_trace)
    monkeypatch.setattr(setup.gen, "render_cfg", lambda: small)
    with _cpu_profile():
        got = setup.request(0)
    c = tracing.snapshot()["counters"]
    assert setup.gen.overflow == 0 and c["trace.grown"] > 0
    assert c["sampler.slots"] > 2 * math.ceil(576 * 0.05)   # a grown buffer
    monkeypatch.setattr(setup.gen, "render_cfg", lambda: whole)
    want = setup.request(0)
    assert setup.gen.overflow == 0
    grown, ref = results
    hit = ref.network_object_mask
    assert torch.equal(grown.network_object_mask, hit) and bool(hit.any())
    assert float((grown.dists - ref.dists)[hit].abs().max()) <= 1e-4
    assert np.array_equal(got[..., 3], want[..., 3])
    assert np.abs(got[..., :3] - want[..., :3]).max() <= 1e-3
    grow[0] = False
    monkeypatch.setattr(setup.gen, "render_cfg", lambda: small)
    setup.request(0)
    assert setup.gen.overflow > 0


def test_traced_render_equals_untraced(setup):
    want = setup.request(2)
    with _cpu_profile():
        got = setup.request(2)
    assert tracing.snapshot()["counters"]["render.chunks"] == 1
    assert np.array_equal(got, want)


def test_device_counter_keeps_its_sum_across_folds():
    n = 3 * tracing._FOLD + 5
    with _cpu_profile():
        for i in range(n):
            tracing.count_device("f", torch.tensor([True, i % 2 == 0]), 3)
        tracing.count_device("f", torch.ones(4, dtype=torch.bool))
        tracing.count("f", 2)
    assert tracing.snapshot()["counters"] == {"f": 3 * (n + (n + 1) // 2) + 4 + 2}


def test_union_counts_overlaps_once():
    assert tracing.union([(5, 9), (0, 3), (2, 4), (9, 12), (20, 21)]) == [
        (0, 4), (5, 12), (20, 21)]
    assert tracing.union([]) == []


def test_profile_at_writes_the_spans(tmp_path):
    from isopoints_torch import train_mvr

    cpu = torch.device("cpu")
    prof = train_mvr._start_profiler(cpu)
    with tracing.span("step"):
        tracing.count("steps")
        torch.ones(8).sum()
    train_mvr._stop_profiler(prof, cpu, str(tmp_path))
    for f in ("trace.json", "ops.txt", "spans.json"):
        assert (tmp_path / f).exists(), f
    with open(tmp_path / "spans.json") as f:
        snap = json.load(f)
    assert [s["name"] for s in snap["spans"]] == ["step"]
    assert snap["counters"] == {"steps": 1}
