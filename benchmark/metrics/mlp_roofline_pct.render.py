"""mlp_roofline_pct.render: the fused MLP kernels' least time (each
launch's products at its precision's peak, or its bytes, whichever
bounds; yardstick/flops.mlp_launch) over their device time in the trace,
the kernels found by function name (fused_mlp.cu, fused_igr.cu and the
wide tile's points_kernel)."""

from benchmark.yardstick import flops

NAMES = {"siren_points_kernel", "igr_points_kernel", "points_kernel"}


def read(ctx):
    from benchmark.trace import kernel_function

    dev_ns = sum(b - a for n, a, b in ctx["device_events"]
                 if kernel_function(n) in NAMES)
    prods = flops.decoder_products(ctx["model"])
    least = sum(flops.least_seconds(*flops.mlp_launch(
        prods, r["n"], r["bf16"], r["with_grad"]), ctx["peaks"])
        for r in ctx["launches"] if r["kernel"] == "mlp")
    if dev_ns <= 0 or least <= 0:
        return None
    return 100.0 * least / (dev_ns / 1e9)
