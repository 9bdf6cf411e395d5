"""mlp_live_pct.render: the share of the points that the render path's MLP
evaluations take that belong to live rays: the sum of the program's
`mlp.live.*` counters over the sum of its `mlp.points.*` counters
(isopoints_torch/tracing.py; PERF.md defines "live" at each site: the
march's unfinished rays, the whole-buffer evaluations' rays inside the
bounding sphere or in a filled slot, the shading's hits). None where the
program keeps no such counters."""


def _snapshot():
    try:
        from isopoints_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def read(ctx):
    snap = _snapshot()
    if not snap:
        return None
    c = snap["counters"]
    points = sum(v for k, v in c.items() if k.startswith("mlp.points."))
    live = sum(v for k, v in c.items() if k.startswith("mlp.live."))
    if points <= 0:
        return None
    return 100.0 * live / points
