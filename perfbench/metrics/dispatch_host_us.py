"""Median host microseconds from entering vortex.ops.gemm to its return
(session API, dispatch engine and selection; no synchronize), over the
window's calls."""
from kit.stats import nearest_rank


def read(ctx):
    host = ctx.run.host_s
    return nearest_rank([h * 1e6 for h in host], 0.5) if host else None
