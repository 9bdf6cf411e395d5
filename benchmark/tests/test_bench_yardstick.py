"""The frozen FLOP and byte counts against hand counts, and every share
bounded by 100% against the file of peaks by construction."""

import json
import os

import pytest

from benchmark.yardstick import flops

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


def _model(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)["model"]


SIREN_MACS = 3 * 256 + 3 * 256 * 256 + 256
# IGR 8x512: layer 3 gives 512 - 3 = 509 so that the input concatenated back
# at layer 4 makes 512 again
IGR_MACS = 3 * 512 + 2 * 512 * 512 + 512 * 509 + 4 * 512 * 512 + 512
TEX_SIREN = 33 * 128 + 2 * 128 * 128 + 128 * 3       # 9 + 24 encoded view
TEX_IGR = 33 * 512 + 3 * 512 * 512 + 512 * 3


@pytest.mark.parametrize("name,macs,tex", [
    ("siren-3x256", SIREN_MACS, TEX_SIREN), ("igr-8x512", IGR_MACS, TEX_IGR)])
def test_products_match_hand_counts(name, macs, tex):
    m = _model(name)
    assert flops.macs(flops.decoder_products(m)) == macs
    assert flops.macs(flops.texture_products(m)) == tex


def test_encoding_and_skip_widths():
    m = {"decoder_type": "sdf",
         "decoder_kwargs": {"hidden_size": 512, "n_layers": 8,
                            "num_frequencies": 6, "skip_in": [4]}}
    prods = flops.decoder_products(m)
    assert prods[0] == (39, 512)            # 3 + 3·2·6 encoded
    assert prods[3] == (512, 512 - 39)      # before the skip
    assert prods[4] == (512, 512)
    assert not flops.has_kernel(dict(m, implicit_kwargs={"use_fused_mlp": True}))


def test_schedule_counts_siren():
    """21 iterations (20 floor < 21), coarse 6 of bf16 with stall, fine 6-8
    full width, stages 8-12 at 0.8 and 12-21 at 0.55, the coarse sampler
    at 0.5 of the chunk: 100 bf16 + 2 + 8 f32."""
    ev = flops.evals_per_ray(_model("siren-3x256"), 16384)
    assert ev["bf16"] == pytest.approx(2 * (1 + 6) + 0.5 * 100)
    assert ev["f32"] == pytest.approx(
        2 + 2 * 2 + 2 * 4 * 0.8 + 2 * 9 * 0.55 + 0.5 * 10, rel=1e-4)


def test_schedule_counts_igr_render_floor():
    """The config's 13 iterations are raised to the render's 20: stages 6-9
    at 0.8 and 9-20 at 0.55 after a coarse phase of 6."""
    ev = flops.evals_per_ray(_model("igr-8x512"), 16384)
    assert ev["bf16"] == pytest.approx(2 * 7 + 50)
    assert ev["f32"] == pytest.approx(2 + 2 * 3 * 0.8 + 2 * 11 * 0.55 + 5,
                                      rel=1e-4)


def test_render_flops_per_ray():
    m = _model("siren-3x256")
    ev = flops.evals_per_ray(m, 16384)
    v = 2.0 * SIREN_MACS
    want = (ev["bf16"] + ev["f32"]) * v + 2 * v + 2.0 * TEX_SIREN
    assert flops.render_flops_per_ray(m, 16384) == pytest.approx(want)


def test_launch_bytes_and_flops():
    prods = flops.decoder_products(_model("siren-3x256"))
    params = sum(a * b + b for a, b in prods)
    bf, f32, by = flops.mlp_launch(prods, 1000, bf16=False, with_grad=True)
    assert (bf, f32) == (0.0, 4.0 * 1000 * SIREN_MACS)   # reverse mode: 2x
    assert by == 1000 * (12 + 4 + 12) + 4 * params
    bf, f32, by = flops.mlp_launch(prods, 1000, bf16=True, with_grad=False)
    assert (bf, f32) == (2.0 * 1000 * SIREN_MACS, 0.0)
    assert by == 1000 * 16 + 2 * params
    bf, f32, _ = flops.sampler_launch(prods, 10, 100, 8, coarse_sweep=True,
                                      fine_bf16=False)
    assert bf == 10 * 100 * 2.0 * SIREN_MACS
    assert f32 == 10 * 10 * 2.0 * SIREN_MACS


def test_peaks_order_and_bounds():
    pk = flops.peaks()
    assert pk["bf16_flops"] == 989e12 and pk["tf32_flops"] == 495e12
    assert pk["f32_flops"] == 67e12 and pk["hbm_bytes"] == 3.35e12
    # the mfu divides by the fastest dense rate the render's precisions have
    assert pk["bf16_flops"] >= pk["tf32_flops"] >= pk["f32_flops"]


@pytest.mark.parametrize("bf,f32,by", [(1e12, 0, 1e6), (0, 1e12, 1e6),
                                       (5e11, 5e11, 1e12), (1, 1, 1e13)])
def test_least_time_is_a_lower_bound(bf, f32, by):
    """Running the counted work at every peak at once reads exactly 100%:
    the least time is the larger of the product time at the peaks and the
    byte time, never their sum."""
    pk = flops.peaks()
    t = flops.least_seconds(bf, f32, by, pk)
    t_mma = bf / pk["bf16_flops"] + f32 / pk["tf32_flops"]
    assert t == pytest.approx(max(t_mma, by / pk["hbm_bytes"]))
    assert t <= t_mma + by / pk["hbm_bytes"]


def test_readers_read_100_at_the_bound():
    """A kernel whose device time equals its least time reads 100%; the
    mfu of a window that runs the counted FLOPs at the bf16 peak reads
    100%."""
    from benchmark import spec

    cell = spec.Cell("siren-3x256.render512x2")
    m, pk = cell.config["model"], flops.peaks()
    launches = [{"kernel": "mlp", "n": 4096, "bf16": False, "with_grad": True},
                {"kernel": "sampler", "n": 8192, "n_steps": 100, "n_secant": 8,
                 "coarse_sweep": True, "fine_bf16": False}]
    prods = flops.decoder_products(m)
    t_mlp = flops.least_seconds(*flops.mlp_launch(prods, 4096, False, True), pk)
    t_smp = flops.least_seconds(*flops.sampler_launch(
        prods, 8192, 100, 8, True, False), pk)
    events = [("void (anonymous namespace)::siren_points_kernel<1>(Net)", 0,
               int(round(t_mlp * 1e9))),
              ("void (anonymous namespace)::sweep_kernel<2>(Net)", 0,
               int(round(t_smp * 1e9)))]
    rays = 10 ** 6
    window = rays * flops.render_flops_per_ray(m, 16384) / pk["bf16_flops"]
    ctx = {"window_s": window, "busy_s": window, "device_events": events,
           "launches": launches, "model": m, "rays": rays,
           "rays_per_view_chunk": 16384, "peaks": pk,
           "csrc_kernels": {"siren_points_kernel", "sweep_kernel"}}
    assert cell.reader("mlp_roofline_pct.render")(ctx) == pytest.approx(100, rel=1e-3)
    assert cell.reader("sampler_roofline_pct.render")(ctx) == pytest.approx(100, rel=1e-3)
    assert cell.reader("mfu_pct.render")(ctx) == pytest.approx(100)
    assert cell.reader("idle_pct.render")(ctx) == pytest.approx(0)
    assert cell.reader("torch_ops_pct.render")(ctx) == pytest.approx(0)


def test_readers_find_nothing_return_none():
    from benchmark import spec

    cell = spec.Cell("igr-8x512.render256x4")
    ctx = {"window_s": 1.0, "busy_s": 0.5, "device_events": [],
           "launches": [], "model": cell.config["model"], "rays": 0,
           "rays_per_view_chunk": 16384, "peaks": flops.peaks(),
           "csrc_kernels": set()}
    for name in ("mlp_roofline_pct.render", "sampler_roofline_pct.render",
                 "torch_ops_pct.render", "mfu_pct.render"):
        assert cell.reader(name)(ctx) is None
