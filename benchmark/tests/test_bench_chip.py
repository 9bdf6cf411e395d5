"""The command on the card: a short run of each cell prints one result line
that keeps the contract. Skips without CUDA.

    python -m pytest --noconftest -o addopts="" benchmark/tests/test_bench_chip.py
"""

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["siren-3x256.render512x2",
                                  "igr-8x512.render256x4"])
@pytest.mark.parametrize("traced", [0, 1])
def test_short_run_keeps_the_contract(card, cell, traced):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(traced)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    c = spec.Cell(cell)
    want = c.per_layer() if traced else c.end_to_end()
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, m in res["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100
    else:
        assert set(res["metrics"]) == {m["name"] for m in want}
