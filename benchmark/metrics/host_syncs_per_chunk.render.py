"""host_syncs_per_chunk.render: the host's waits on the device in the traced
window, per chunk the window rendered: the sum of the program's
`host_syncs.*` counters (isopoints_torch/tracing.py: the ray engine's loop
exit tests, host-to-device copies, the readback of each request) over its
`render.chunks`. None where the program keeps no such counters."""


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
    chunks = c.get("render.chunks", 0)
    if chunks <= 0:
        return None
    return sum(v for k, v in c.items() if k.startswith("host_syncs.")) / chunks
