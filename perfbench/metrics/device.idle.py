"""Share of the traced window in which no kernel and no copy ran on the
device: one less the union of their intervals over the window."""
from perfbench.timing import covered


def read(ctx):
    win = ctx.traced_window()
    if win is None or not ctx.trace.device:
        return None
    lo, hi = win
    return 100.0 * (1.0 - covered(ctx.trace.device_union(), lo, hi)
                    / (hi - lo))
