"""Served capacity: requests completed within the window over its
length, timed from the clients' side."""


def read(ctx):
    if ctx.window.unit != "requests":
        return None
    return ctx.window.completed / ctx.window.seconds
