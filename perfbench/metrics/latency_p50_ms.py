"""The median wall time of a ``Program.run`` call, from the call to its
return with the outputs on the host, over every call in the window."""
import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if ctx.window.unit != "samples" or not lat:
        return None
    return float(np.median(np.asarray(lat))) * 1e3
