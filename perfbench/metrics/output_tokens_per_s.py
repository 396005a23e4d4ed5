"""Output tokens read back inside the window, over the window's seconds
(the tokens of requests submitted in the pre-roll count where they are
read back inside it)."""


def read(ctx):
    run = ctx.run
    n = sum(1 for r in run.reqs + run.pre for t in r.times
            if run.t_window <= t <= run.t_close)
    return n / (run.t_close - run.t_window)
