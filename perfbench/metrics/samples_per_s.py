"""Offline rate: trains completed over the whole window, on the host's
clock (the window ends at a completed call)."""


def read(ctx):
    if ctx.window.unit != "samples":
        return None
    return ctx.window.completed / ctx.window.seconds
