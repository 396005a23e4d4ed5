"""Share of the traced slice in which the grouped GEMM (csrc/grouped_gemm.cu)
runs.  Its tensor-core path shares the ``tc_gemm_kernel`` symbol with the
dense GEMM; on the serving "aot" path every dense projection is cuBLAS,
so there every ``tc_gemm_kernel`` launch is a grouped one."""

KERNEL = r"::tc_gemm_kernel<|::grouped_gemm_kernel<"


def read(ctx):
    if ctx.trace is None:
        return None
    dev_us, n, _ = ctx.trace.kernel_us(KERNEL)
    return 100.0 * dev_us / ctx.trace.window_us if n else None
