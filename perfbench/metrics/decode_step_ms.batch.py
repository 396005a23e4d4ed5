"""Mean decode span (server.decode_vec, one graph replay, with its
synchronize) over the batched steps started inside the window."""


def read(ctx):
    steps = ctx.window_steps()
    return sum(s.t1 - s.t0 for s in steps) * 1e3 / len(steps) if steps \
        else None
