"""sampler_roofline_pct.render: the fused sampler kernel's least time (each
launch's rays x (n_steps + 2 re-validated + n_secant) values at their
precisions' peaks, or its bytes; yardstick/flops.sampler_launch) over its
device time in the trace (fused_sampler.cu's sweep kernels by name)."""

from benchmark.yardstick import flops

NAMES = {"sweep_kernel", "wide_sweep_kernel"}


def read(ctx):
    from benchmark.trace import kernel_function

    dev_ns = sum(b - a for n, a, b in ctx["device_events"]
                 if kernel_function(n) in NAMES)
    prods = flops.decoder_products(ctx["model"])
    least = sum(flops.least_seconds(*flops.sampler_launch(
        prods, r["n"], r["n_steps"], r["n_secant"], r["coarse_sweep"],
        r["fine_bf16"]), ctx["peaks"])
        for r in ctx["launches"] if r["kernel"] == "sampler")
    if dev_ns <= 0 or least <= 0:
        return None
    return 100.0 * least / (dev_ns / 1e9)
