"""``device.idle`` in the serve cells, where it moves ``serve_rps``."""
from perfbench import spec


def read(ctx):
    return spec.reader(ctx.root, "device.idle").read(ctx)
