"""idle_pct.render: the share of the traced window in which no kernel, copy
or set ran on the device (overlapping operations counted once)."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
