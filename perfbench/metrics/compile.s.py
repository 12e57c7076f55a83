"""Wall seconds of the ``repro_torch.core.compile`` call in set-up."""


def read(ctx):
    return ctx.compile_s
