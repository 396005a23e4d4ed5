"""vortex_gemm (csrc/gemm.cu) against its roofline over the traced slice:
the sum of each call's bound at its true M (2MNK at the bf16 peak or
2(MK + KN + MN) bytes at the HBM peak, whichever takes longer) over the
device time of the GEMM kernels."""
from kit import counts

KERNEL = r"::tc_gemm_kernel<|::gemm_kernel<"


def read(ctx):
    if ctx.trace is None:
        return None
    dev_us, n, _ = ctx.trace.kernel_us(KERNEL)
    calls = ctx.slice_calls()
    if not n or not calls:
        return None
    shapes = ctx.run.shapes
    bound = sum(counts.gemm_bound_s(m, shapes[j][1], shapes[j][0])
                for m, j in calls)
    return 100.0 * bound / (dev_us * 1e-6)
