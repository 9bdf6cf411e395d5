"""A rehearsal of each cell on the CPU at a tiny size, through the harness
with its look for a card skipped: the port's plain route agrees with the
reference within the cell's limits; the control (the reference in
bfloat16 in the program's place) and each fault the cell can have, planted
under the timed path, come out not correct."""

import pytest
import torch

from benchmark import check, control, harness, spec

SIREN = "siren-3x256.render512x2"
IGR = "igr-8x512.render256x4"
TINY = {
    SIREN: {"mix": {"image_size": 24, "rays_per_chunk": 576},
            "fit": {"steps": 150, "points": 4096},
            "check": {"requests": 2, "rays": 512}},
    IGR: {"mix": {"image_size": 16, "rays_per_chunk": 256},
          "fit": {"steps": 40, "points": 2048},
          "check": {"requests": 1, "rays": 256}},
}
SEED = 3_000_000_019


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell):
    return harness.run(cell, SEED, 0.0, False, "cpu", overrides=TINY[cell])[0]


@pytest.mark.parametrize("cell", [SIREN, IGR])
def test_plain_route_agrees_with_the_reference(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"render_rays_per_s", "setup_s"}


@pytest.mark.parametrize("cell", [SIREN, IGR])
def test_bf16_control_is_not_correct(cell):
    r = control.readings(cell, SEED, True, "cpu", TINY[cell])
    ok, checks = check.judge(r, spec.Cell(cell).limits)
    assert not ok, checks


def _state_unchanged(monkeypatch):
    from isopoints_torch.models import raytracing

    monkeypatch.setattr(raytracing, "_run_loop", lambda st, *a, **k: st)


def _half_left_out(monkeypatch):
    from isopoints_torch.models.generator import Generator

    orig = Generator.render_chunk

    def half(self, *a, **k):
        rgba, ovf = orig(self, *a, **k)
        n = rgba.shape[1]
        rgba = rgba.clone()
        rgba[:, n // 2:, :3] = 1.0
        rgba[:, n // 2:, 3] = 0.0
        return rgba, ovf

    monkeypatch.setattr(Generator, "render_chunk", half)


def _answer_altered(monkeypatch):
    from isopoints_torch.models import implicit

    orig = implicit.neural_texture
    monkeypatch.setattr(implicit, "neural_texture",
                        lambda *a, **k: orig(*a, **k) + 0.02)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run(SIREN)
    assert not res["correct"], res["checks"]
