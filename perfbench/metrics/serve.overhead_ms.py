"""The serve layer's cost a batch: the window over the batches the
server completed in it, less the wall time of one direct ``Program.run``
on the same ``max_batch`` shape, timed right after the window in the
same process."""


def read(ctx):
    if ctx.direct_ms is None or not ctx.window.batches:
        return None
    return ctx.window.seconds * 1e3 / ctx.window.batches - ctx.direct_ms
