"""Seconds from the process's start to the window's opening: imports,
the CUDA context, the network from the seed, ``compile``, the inputs,
graph capture and warm-up."""


def read(ctx):
    return ctx.setup_s
