"""The model's FLOPs for the tokens processed in the traced slice over the
slice's seconds at the chip's bf16 peak: each prompt token at its
prefill (the head once, at the last), each active row once per decode
step, attention over each token's true keys.  perfbench's own count,
from the configuration file."""
from kit import counts


def read(ctx):
    if ctx.trace is None:
        return None
    m = ctx.model
    f = sum(counts.decode_flops(m, s.kv_lens) for s in ctx.slice_steps())
    f += sum(counts.prefill_flops(m, p.prompt_len)
             for p in ctx.slice_prefills())
    return 100.0 * f / (ctx.trace.window_us * 1e-6 * counts.PEAK_FLOPS)
