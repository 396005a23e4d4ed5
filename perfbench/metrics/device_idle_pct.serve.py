"""Share of the traced slice's wall time in which no kernel, copy or fill
ran on the device."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
