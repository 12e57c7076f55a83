"""Device time of host <-> device copies a call: the profiler's memcpy
activities inside the traced window over the calls in it."""


def read(ctx):
    win = ctx.traced_window()
    if win is None or not ctx.window.calls:
        return None
    lo, hi = win
    copies = [d for d in ctx.trace.device
              if d.kind == "gpu_memcpy" and d.start >= lo and d.end <= hi]
    if not copies:
        return None
    return sum(d.dur for d in copies) * 1e3 / ctx.window.calls
