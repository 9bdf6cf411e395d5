"""mfu_pct.render: the FLOPs that the configuration's schedule prescribes
for the window's rays (yardstick/flops.render_flops_per_ray: the trace's
upper bound, one value+grad and one texture evaluation a ray) over the
window at the card's dense bf16 peak. Reads nothing from the program."""

from benchmark.yardstick import flops


def read(ctx):
    if ctx["rays"] <= 0 or ctx["window_s"] <= 0:
        return None
    fl = ctx["rays"] * flops.render_flops_per_ray(ctx["model"],
                                                  ctx["rays_per_view_chunk"])
    return 100.0 * fl / (ctx["window_s"] * ctx["peaks"]["bf16_flops"])
