"""Plain float32 forward of a decoder whose layers follow a pattern of
mixers and MLPs (``model["pattern"]``, as the configuration file states
it): grouped-query attention, Mamba-1 and multi-head latent attention,
each followed by a dense SwiGLU MLP, routed SwiGLU experts with shared
experts beside them, or nothing.  No kernel, no cache, no batching,
nothing of the program; TF32 off.

Each layer is pre-norm: RMSNorm (epsilon ``norm_eps``) before the mixer
and before the MLP, each added to the residual stream; a final RMSNorm
and the LM head (the embedding's transpose where tied, else
``lm_head``) over the true vocabulary.

* Attention: as ``reference/decoder.py`` has it; with no positional
  encoding where the file's ``attn_rope`` is false.
* Mamba-1: ``x, z = x W_in``; a causal depthwise conv of ``d_conv`` taps
  with its bias, then SiLU; ``dt, B, C = xc W_x``, each through an
  RMSNorm with its weight (``dt_norm``, ``b_norm``, ``c_norm``) where the
  file's ``ssm["inner_norms"]`` is true;
  ``Delta = softplus(dt W_dt + b_dt)``; ``A = -exp(A_log)``; the
  selective scan ``h_t = exp(Delta_t A) h_{t-1} + Delta_t x_t B_t``,
  ``y_t = C_t h_t + D x_t``, run token by token from a zero state in
  float32; gated by ``SiLU(z)``; ``y W_out``.
* MLA, the naive (decompressed) form: ``q = RMSNorm(x W_dq) W_uq`` split
  into a no-position part and a rotary part; ``c = RMSNorm((x W_dkv)[:r])``
  with the rest of ``x W_dkv`` the one rotary key shared by every head;
  ``k = [c W_uk, rope(k_rope)]``, ``v = c W_uv``; causal softmax
  attention scaled by (qk_nope_dim + qk_rope_dim)^-0.5; ``o W_o``.
* Experts: routed as ``reference/decoder.py`` routes them (a prompt's
  tokens as one group under the file's capacity rule, none dropped
  where its ``capacity_factor`` is null, a token fed back after it
  alone), each expert run on the tokens it admitted; the shared
  experts' SwiGLU over every token added.

:func:`logits` runs a sequence teacher-forced, as ``decoder.logits``
does, with the same arguments.  With ``weight_fmt="fp8"`` every matrix
product of the layers and the head takes both operands rounded to float8
e4m3 under per-tensor scales: the control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.decoder import _mm, attention, rmsnorm, routed, rope

SCAN_BLOCK = 256  # tokens whose decays are formed at once in the scan


def _pattern(model: dict) -> list[dict]:
    if "pattern" in model:
        return model["pattern"]
    return [{"mixer": "attn", "mlp": "moe" if model.get("moe") else "dense"}]


def _attn(x, p, model, fmt):
    t = x.shape[0]
    h, kvh, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    theta = model["rope_theta"]
    q = _mm(x, p["wq"], fmt).reshape(t, h, hd).transpose(0, 1)
    k = _mm(x, p["wk"], fmt).reshape(t, kvh, hd).transpose(0, 1)
    v = _mm(x, p["wv"], fmt).reshape(t, kvh, hd).transpose(0, 1)
    if model.get("attn_rope", True):
        q, k = rope(q, theta), rope(k, theta)
    o = attention(q, k, v)
    return _mm(o.transpose(0, 1).reshape(t, h * hd), p["wo"], fmt)


def _mla(x, p, model, fmt):
    m, h, eps = model["mla"], model["n_heads"], model["norm_eps"]
    nope, rd, dv, c = (m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"],
                       m["kv_lora_rank"])
    t = x.shape[0]
    theta = model["rope_theta"]
    cq = rmsnorm(_mm(x, p["wdq"], fmt), p["q_norm"], eps)
    q = _mm(cq, p["wuq"], fmt).reshape(t, h, nope + rd).transpose(0, 1)
    ckv = _mm(x, p["wdkv"], fmt)
    lat = rmsnorm(ckv[:, :c], p["kv_norm"], eps)
    k_rope = rope(ckv[None, :, c:], theta).expand(h, t, rd)
    k_nope = _mm(lat, p["wuk"], fmt).reshape(t, h, nope).transpose(0, 1)
    v = _mm(lat, p["wuv"], fmt).reshape(t, h, dv).transpose(0, 1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    o = attention(q, torch.cat([k_nope, k_rope], dim=-1), v)
    return _mm(o.transpose(0, 1).reshape(t, h * dv), p["wo"], fmt)


def _scan(dt, xc, B, C, A) -> torch.Tensor:
    """y_t = C_t h_t with h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t from
    h_0 = 0, one token after another: dt, xc (T, di), B, C (T, ds), A
    (di, ds) -> (T, di).  The decays and inputs of ``SCAN_BLOCK`` tokens
    are formed at once; the recurrence itself runs in order."""
    t, di = xc.shape
    h = torch.zeros_like(A)
    y = torch.empty_like(xc)
    for i in range(0, t, SCAN_BLOCK):
        j = min(t, i + SCAN_BLOCK)
        a = torch.exp(dt[i:j, :, None] * A)
        hs = (dt[i:j] * xc[i:j])[:, :, None] * B[i:j, None, :]
        for n in range(j - i):
            h = torch.addcmul(hs[n], a[n], h, out=hs[n])
        y[i:j] = torch.einsum("tds,ts->td", hs, C[i:j])
    return y


def _mamba(x, p, model, fmt):
    s = model["ssm"]
    di, ds, dc, dtr = s["d_inner"], s["d_state"], s["d_conv"], s["dt_rank"]
    t = x.shape[0]
    xz = _mm(x, p["in_proj"], fmt)
    xi, z = xz[:, :di], xz[:, di:]
    w = p["conv_w"].float()
    pad = F.pad(xi, (0, 0, dc - 1, 0))
    xc = p["conv_b"].float() + sum(w[k] * pad[k:k + t] for k in range(dc))
    xc = F.silu(xc)
    proj = _mm(xc, p["x_proj"], fmt)
    dt, B, C = proj[:, :dtr], proj[:, dtr:dtr + ds], proj[:, dtr + ds:]
    if s.get("inner_norms", False):
        eps = model["norm_eps"]
        dt, B, C = (rmsnorm(u, p[n], eps) for u, n in (
            (dt, "dt_norm"), (B, "b_norm"), (C, "c_norm")))
    dt = F.softplus(_mm(dt, p["dt_proj"], fmt) + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = _scan(dt, xc, B, C, A)
    y = (y + p["D"].float() * xc) * F.silu(z)
    return _mm(y, p["out_proj"], fmt)


def _swiglu(x, w_gate, w_in, w_out, fmt):
    return _mm(F.silu(_mm(x, w_gate, fmt)) * _mm(x, w_in, fmt), w_out, fmt)


def _experts(x, p, model, n_group, group_len, fmt):
    """Routed experts over x (T, d), the first ``n_group`` tokens the
    prompt's group with capacity from ``group_len`` (``decoder.routed``),
    each expert on the tokens it admitted, plus the shared experts over
    every token."""
    comb = routed(x, p["router"], model, n_group, group_len)
    out = torch.zeros_like(x)
    for j in range(comb.shape[1]):
        rows = comb[:, j].nonzero()[:, 0]
        if rows.numel():
            y = _swiglu(x[rows], p["w_gate"][j], p["w_in"][j],
                        p["w_out"][j], fmt)
            out.index_add_(0, rows, y * comb[rows, j, None])
    if "shared_in" in p:
        out = out + _swiglu(x, p["shared_gate"], p["shared_in"],
                            p["shared_out"], fmt)
    return out


@torch.no_grad()
def logits(weights: dict, model: dict, tokens: torch.Tensor, prompt_len: int,
           group_len: int, weight_fmt: str = "f32",
           first: int | None = None) -> torch.Tensor:
    """Logits (T - first, vocab) at positions ``first`` .. T - 1 of the
    token sequence ``tokens`` (T,), the prompt followed by the served
    tokens but the last; ``first`` is prompt_len - 1 unless given."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fmt = weight_fmt
    eps = model["norm_eps"]
    x = weights["embed"][tokens].float()
    pattern = _pattern(model)
    mixers = {"attn": _attn, "mamba": _mamba, "mla": _mla}
    for g in range(model["n_layers"] // len(pattern)):
        for i, spec in enumerate(pattern):
            layer = weights[f"pos{i}"]
            mix = spec["mixer"]
            p = {n: w[g] for n, w in layer[mix].items()}
            hn = rmsnorm(x, layer["norm_mixer"][g], eps)
            x = x + mixers[mix](hn, p, model, fmt)
            if spec["mlp"] == "none":
                continue
            hn = rmsnorm(x, layer["norm_mlp"][g], eps)
            if spec["mlp"] == "moe":
                p = {n: w[g] for n, w in layer["moe"].items()}
                x = x + _experts(hn, p, model, prompt_len, group_len, fmt)
            else:
                p = layer["mlp"]
                x = x + _swiglu(hn, p["w_gate"][g], p["w_in"][g],
                                p["w_out"][g], fmt)
    start = prompt_len - 1 if first is None else first
    x = rmsnorm(x[start:], weights["final_norm"], eps)
    vocab = model["vocab"]
    head = weights["embed"][:vocab].T if model["tie_embeddings"] else \
        weights["lm_head"][:, :vocab]
    return _mm(x, head, fmt)
