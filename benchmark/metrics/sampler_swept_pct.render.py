"""sampler_swept_pct.render: the share of the sampler kernel's slots that it
swept: the program's `sampler.swept` (the slots of the tiles its persistent
grid walked over a compacted buffer's filled slots; every slot where the
buffer is one full row, or on the plain sweep) over `sampler.slots` (the
slots it is launched on), counted in isopoints_torch/tracing.py. None where
the program keeps no such counters (a program whose kernel sweeps every
slot has no `sampler.swept`)."""


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
    if slots <= 0 or "sampler.swept" not in c:
        return None
    return 100.0 * c["sampler.swept"] / slots
