"""The 95th percentile of submit -> result over every request completed
in the window, on the benchmark's clock."""
import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if len(lat) < 20:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
