"""Host time a call: each ``engine.run`` span's wall time less the part
of it in which the device was busy (the input's conversion and copy
set-up, allocation, the replay's launch, the outputs' finalization),
averaged over the calls."""
from perfbench.timing import covered


def read(ctx):
    if ctx.traced_window() is None:
        return None
    spans = ctx.trace.spans_named("engine.run")
    if not spans:
        return None
    merged = ctx.trace.device_union()
    starts = [a for a, _ in merged]
    host = [s.dur - covered(merged, s.start, s.end, starts) for s in spans]
    return sum(host) * 1e3 / len(host)
