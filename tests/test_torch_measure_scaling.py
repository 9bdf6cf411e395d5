"""The port's weak-scaling script (isopoints_torch/measure_scaling.py, the
port of scripts/measure_scaling.py) at world sizes 1 and 2 on gloo ranks,
on the CPU, at a small size (the script's SIREN 3 x 256, 64 rays a rank,
32 px, one thread a rank: the test's one thread over the ranks).

- One JSON line a world size, with the JAX script's keys and the port's
  `device`, labelled with the process group's backend (gloo here);
  `weak_scaling_efficiency` is rays/s(N) / (N · rays/s(1)) of the line's
  own numbers, 1 at world size 1; with `--total-rays` the lines hold the
  total fixed and report `partition_overhead_efficiency` instead.
- `scaling_line` on given times: the two formulas exactly.
"""

import json

import pytest
import torch

from isopoints_torch import measure_scaling

SMALL = ["--device", "cpu", "--image-size", "32", "--iters", "2"]
JAX_KEYS = {"backend", "n_devices", "rays_per_device", "total_rays_per_s",
            "step_ms"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_weak_scaling_lines_at_one_and_two_ranks(capsys):
    lines = measure_scaling.main(["--world-sizes", "1", "2",
                                  "--rays-per-device", "64", *SMALL])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    assert printed == lines and [x["n_devices"] for x in lines] == [1, 2]
    for x in lines:
        assert set(x) == JAX_KEYS | {"device", "weak_scaling_efficiency"}
        assert x["backend"] == "gloo" and x["device"] == "cpu"
        assert x["rays_per_device"] == 64 and x["step_ms"] > 0
        assert x["total_rays_per_s"] == pytest.approx(
            64 * x["n_devices"] / (x["step_ms"] / 1e3), rel=1e-3)
    one, two = lines
    assert one["weak_scaling_efficiency"] == 1.0
    assert two["weak_scaling_efficiency"] == pytest.approx(
        two["total_rays_per_s"] / (2 * one["total_rays_per_s"]), abs=1e-3)


def test_constant_total_work_line():
    lines = measure_scaling.main(["--world-sizes", "2", "--total-rays", "128",
                                  *SMALL])
    assert len(lines) == 1 and lines[0]["rays_per_device"] == 64
    # no world size 1 in the run: nothing to compare with
    assert lines[0]["partition_overhead_efficiency"] != \
        lines[0]["partition_overhead_efficiency"]


def test_scaling_line_formulas():
    one = measure_scaling.scaling_line(1, 100, 0.5, "nccl", "card")
    assert one["total_rays_per_s"] == 200.0 and one["weak_scaling_efficiency"] == 1.0
    four = measure_scaling.scaling_line(4, 100, 1.0, "nccl", "card", 200.0)
    assert four["weak_scaling_efficiency"] == 0.5 and four["step_ms"] == 1000.0
    tot = measure_scaling.scaling_line(2, 50, 0.2, "gloo", "cpu", 200.0,
                                       constant_total=True)
    assert tot["partition_overhead_efficiency"] == 2.5
