"""torch_ops_pct.render: the share of the device time in operations that
are not the program's own kernels (the `__global__` functions of
isopoints_torch/csrc/): PyTorch's kernels, cuBLAS, copies and sets."""


def read(ctx):
    from benchmark.trace import kernel_function

    own = ctx["csrc_kernels"]
    total = other = 0
    for n, a, b in ctx["device_events"]:
        total += b - a
        if kernel_function(n) not in own:
            other += b - a
    if total <= 0:
        return None
    return 100.0 * other / total
