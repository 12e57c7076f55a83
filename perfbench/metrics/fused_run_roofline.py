"""``fused_run``'s share of its roofline: the frozen count's bound
(``kernels/fused_run.py``, at the call's batch) over the kernel's mean
device time a launch in the traced window."""
KERNEL = "fused_run"


def read(ctx):
    win = ctx.traced_window()
    batch = ctx.net.get("batch")
    if win is None or not batch:
        return None
    k = ctx.kernel(KERNEL)
    lo, hi = win
    runs = [d.dur for d in ctx.trace.device
            if d.kind == "kernel" and k.NAME_MATCH in d.name
            and d.start >= lo and d.end <= hi]
    if not runs:
        return None
    bound = ctx.peaks.bound_s(k.bytes_moved(ctx.net, batch),
                              k.operations(ctx.net, batch))
    return 100.0 * bound / (sum(runs) / len(runs))
