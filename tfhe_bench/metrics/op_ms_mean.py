"""End-to-end metric `op_ms_mean`, host clock: the window's milliseconds over
the units completed in it, so a stall anywhere in the window moves it."""


def read(ctx):
    return 1e3 * ctx.window.seconds / len(ctx.units)
