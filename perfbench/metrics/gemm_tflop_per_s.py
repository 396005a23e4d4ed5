"""Sum of 2*M*N*K at each call's true M over the calls of the window,
over the window's seconds (the synchronize() that closes it counted)."""


def read(ctx):
    run = ctx.run
    return run.flops() / (run.t_end - run.t_window) / 1e12
