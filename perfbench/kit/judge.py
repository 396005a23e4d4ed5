"""``correct``: what the timed path produced, held against the plain
reference after the window, each number beside its limit.

Serving: the window's tracked requests (a seed-drawn share, and each one
longer than every request before it, so the longest is among them) that
finished are run through the reference teacher-forced (prompt, then the
served tokens).  At every decode position the row's logits the program
returned, kept at a seed-drawn set of vocabulary ids and at the served
token, are held against the reference's at the same ids:
``decode_logit_err_mean`` is the mean over positions of the root mean
square difference over the spread of the reference's logits there.  It
judges the decode graph, decode attention through the cache the timed
path built and, through that cache, the prefill.  Beside it: the gap by
which the reference's logit of each served token lies below its best
(``logit_gap_max``, the widest), the share of served tokens that are not
the reference's first choice, and with ``first_token_all`` the same at
the first token of every finished request (``first_token_gap_mean``...).
A cell compares the numbers its ``limits`` name; the others are printed
with no limit.

The control is the reference itself with every matrix product on float8
e4m3 operands, put in the program's place at the same positions: its
logits, and the token it ranks first.  With ``--control 1`` its readings
replace the program's of the same names and are judged by the same
:func:`verdict`.

GEMM stream: ``gemm_err_max`` is the largest ``max |out - ref| / max
|ref|`` over the sampled calls, ``ref`` the float32 product of the same
operands; the control is the product of the operands rounded to float8.
"""
from __future__ import annotations

import torch

from kit import weights
from reference import decoder, matmul


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _gap(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit less its logit of
    ``tokens``."""
    return ref.max(dim=-1).values - ref.gather(1, tokens[:, None])[:, 0]


def _rel_err(got: torch.Tensor, want: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """Per position: the root mean square of ``got - want`` over the
    position's compared logits, over the spread (standard deviation) of
    the reference's logits at the sampled ids."""
    rms = (got - want).pow(2).mean(-1).sqrt()
    return rms / scale.std(-1).clamp_min(1e-30)


def _compared(ref: torch.Tensor, ids: torch.Tensor,
              served: torch.Tensor) -> torch.Tensor:
    """A decode position's compared logits: those at the sampled ids and
    the one of the token served there."""
    return torch.cat([ref.index_select(1, ids),
                      ref.gather(1, served[:, None])], dim=1)


def serve_checks(run, seed: int, control: bool) -> tuple[dict, dict]:
    """The serving cell's numbers after the program's state is freed, and
    with ``control`` the control's readings of the same names."""
    _tf32_off()
    model, dev, cell = run.model, run.device, run.cell
    ws = weights.draw(model, seed, dev)
    first_all = cell.get("first_token_all", False)
    picked = [r for r in run.reqs if r.tracked and r.out is not None]
    rest = [r for r in run.reqs if first_all and r.out is not None
            and not r.tracked]
    ids = run.logit_ids
    gap, cgap, fgap, cfgap, n_tok, n_dec, unkept = 0.0, 0.0, 0.0, 0.0, 0, 0, 0
    miss = cmiss = fmiss = cfmiss = n_first = 0
    fsum = cfsum = 0.0
    errs, cerrs = [], []
    for r in picked + rest:
        served = torch.as_tensor(r.out, device=dev)
        if not r.tracked:
            served = served[:1]
        seq = torch.cat([torch.as_tensor(r.tokens[0], device=dev),
                         served[:-1]])
        ref = decoder.logits(ws, model, seq, r.prompt_len, r.group_len)
        g = _gap(ref, served)
        best = ref.argmax(-1)
        if r.tracked:
            gap = max(gap, float(g.max()))
            miss += int((best != served).sum())
            n_tok += served.numel()
            # Decode positions: the steps after the prefill's token.
            dref, dtok = ref[1:], served[1:]
            if len(r.kept) != dtok.numel():
                unkept += 1
            elif r.kept:
                got = torch.stack([torch.cat([a, b[None]])
                                   for a, b in r.kept]).to(dev)
                want = _compared(dref, ids, dtok)
                errs.append(_rel_err(got, want, want[:, :-1]))
                n_dec += dtok.numel()
        fgap = max(fgap, float(g[0]))
        fsum += float(g[0])
        fmiss += int(best[0] != served[0])
        n_first += 1
        if control:
            low = decoder.logits(ws, model, seq, r.prompt_len, r.group_len,
                                 weight_fmt="fp8")
            lowtok = low.argmax(-1)
            c = _gap(ref, lowtok)
            if r.tracked:
                cgap = max(cgap, float(c.max()))
                cmiss += int((best != lowtok).sum())
                if r.kept:
                    want = _compared(ref[1:], ids, lowtok[1:])
                    got = _compared(low[1:], ids, lowtok[1:])
                    cerrs.append(_rel_err(got, want, want[:, :-1]))
            cfgap = max(cfgap, float(c[0]))
            cfsum += float(c[0])
            cfmiss += int(best[0] != lowtok[0])
            del low
        del ref
    failed = sum(r.out is None for r in run.reqs)
    short = sum(r.out is not None and len(r.times) != r.max_new
                for r in run.reqs)
    pct = (lambda k, n: 100.0 * k / n if n else 0.0)
    err = torch.cat(errs) if errs else torch.zeros(1)
    out = {
        "failed_requests": (failed, 0),
        "token_count_mismatches": (short, 0),
        "requests_without_kept_logits": (unkept, 0),
        "compared_tokens": (n_dec, cell["check_tokens"]),
        "decode_logit_err_mean": float(err.mean()),
        "decode_logit_err_max": float(err.max()),
        "logit_gap_max": gap,
        "mismatch_pct": pct(miss, n_tok),
    }
    ctl = {}
    if first_all:
        out["first_token_gap_max"] = fgap
        out["first_token_mismatch_pct"] = pct(fmiss, n_first)
        out["first_token_gap_mean"] = fsum / max(n_first, 1)
    if control:
        cerr = torch.cat(cerrs) if cerrs else torch.zeros(1)
        ctl = {"decode_logit_err_mean": float(cerr.mean()),
               "decode_logit_err_max": float(cerr.max()),
               "logit_gap_max": cgap, "mismatch_pct": pct(cmiss, n_tok)}
        if first_all:
            ctl["first_token_gap_max"] = cfgap
            ctl["first_token_mismatch_pct"] = pct(cfmiss, n_first)
            ctl["first_token_gap_mean"] = cfsum / max(n_first, 1)
    return out, ctl


def limited(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit: a pair already carries one; a bare
    number takes the cell's limit of its name, or none when the cell
    does not compare it."""
    return {name: v if isinstance(v, tuple) else (v, limits.get(name))
            for name, v in numbers.items()}


def gemm_checks(run, control: bool) -> tuple[dict, dict]:
    """The GEMM stream's numbers over the kept calls, and with
    ``control`` the control's reading."""
    _tf32_off()
    err, cerr = 0.0, 0.0
    for c, out in sorted(run.kept.items()):
        m, j = run.calls[c]
        k, _ = run.shapes[j]
        a, b = run.acts[k][:m], run.weights[j]
        ref = matmul.matmul(a, b)
        scale = ref.abs().max().clamp_min(1e-30)
        err = max(err, float((out.float() - ref).abs().max() / scale))
        if control:
            low = matmul.matmul(a, b, fmt="fp8")
            cerr = max(cerr, float((low - ref).abs().max() / scale))
    out = {
        "compared_calls": (len(run.kept), 1 + len(run.shapes)),
        "gemm_err_max": err,
    }
    return out, ({"gemm_err_max": cerr} if control else {})


def verdict(checks: dict) -> bool:
    """Every number that has a limit within it; counts of compared items
    at least their floor.  A number the cell does not compare decides
    nothing."""
    ok = True
    for name, (value, limit) in checks.items():
        if limit is None:
            continue
        if name.startswith("compared_"):
            ok &= value >= limit
        else:
            ok &= value <= limit
    return bool(ok)
