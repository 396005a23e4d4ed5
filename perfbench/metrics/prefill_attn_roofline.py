"""Prefill attention (csrc/attention_tc.cu, or csrc/attention.cu's FMA
path) against its roofline over the traced slice: every layer's causal
bound at each prefill's true prompt length, over the device time of the
prefill attention kernels."""
from kit import counts

KERNEL = r"::attn_(tc_)?kernel<"


def read(ctx):
    if ctx.trace is None:
        return None
    dev_us, n, _ = ctx.trace.kernel_us(KERNEL)
    ps = ctx.slice_prefills()
    if not n or not ps:
        return None
    m = ctx.model
    bound = sum(m["n_layers"] * counts.prefill_attn_bound_s(m, p.prompt_len)
                for p in ps)
    return 100.0 * bound / (dev_us * 1e-6)
