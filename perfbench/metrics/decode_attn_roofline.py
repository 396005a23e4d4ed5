"""Decode attention (csrc/attention_decode.cu) against its roofline over
the traced slice: the bound of every layer of every step in the slice
(K and V once over each active row's true kv_len, q and out, or the
FLOPs, whichever takes longer) over the device time of the
``attn_decode_kernel`` launches."""
from kit import counts

KERNEL = r"::attn_decode_kernel<"


def read(ctx):
    if ctx.trace is None:
        return None
    dev_us, n, _ = ctx.trace.kernel_us(KERNEL)
    steps = ctx.slice_steps()
    if not n or not steps:
        return None
    m = ctx.model
    bound = sum(m["n_layers"] * counts.decode_attn_bound_s(m, s.kv_lens)
                for s in steps)
    return 100.0 * bound / (dev_us * 1e-6)
