"""sampler_live_pct.render: the share of the sampler kernel's slots that
hold a ray: the program's `sampler.live` (the filled slots of the
compacted buffer it sweeps) over `sampler.slots` (the slots it is launched
on), counted in isopoints_torch/tracing.py. None where the program keeps
no such counters."""


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
    slots = c.get("sampler.slots", 0)
    if slots <= 0:
        return None
    return 100.0 * c.get("sampler.live", 0) / slots
