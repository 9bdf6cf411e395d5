"""trace_idle_pct.render: the device's idle time inside the program's
`render.trace` spans (isopoints_torch/tracing.py: each chunk's ray trace,
on the host's clock), as a share of the traced window: each span's length
less the part of it that the union of the window's device events covers.
None where the program records no such spans."""

import bisect


def _snapshot():
    try:
        from isopoints_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def read(ctx):
    from benchmark.trace import union

    snap = _snapshot()
    if not snap or ctx["window_s"] <= 0:
        return None
    spans = [(s["start_ns"], s["end_ns"]) for s in snap["spans"]
             if s["name"] == "render.trace"]
    if not spans:
        return None
    busy = union([(a, b) for _, a, b in ctx["device_events"]])
    starts = [a for a, _ in busy]
    ends = [b for _, b in busy]
    cum = [0]
    for a, b in busy:
        cum.append(cum[-1] + b - a)
    idle = 0
    for lo, hi in spans:
        i = bisect.bisect_right(ends, lo)     # first interval ending after lo
        j = bisect.bisect_left(starts, hi)    # intervals starting before hi
        cov = 0
        if i < j:
            cov = (cum[j] - cum[i] - max(0, lo - starts[i])
                   - max(0, ends[j - 1] - hi))
        idle += (hi - lo) - cov
    return 100.0 * idle / 1e9 / ctx["window_s"]
