"""The whole call's share of the card's int8 peak: 2 x synapses x T
operations a train, over the trains completed in the window."""


def read(ctx):
    if ctx.window.unit != "samples":
        return None
    ops = 2 * ctx.net["synapses"] * ctx.net["timesteps"] * \
        ctx.window.completed
    return 100.0 * ops / ctx.window.seconds / ctx.peaks.INT8_OPS_PER_S
