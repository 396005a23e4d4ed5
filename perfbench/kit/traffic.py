"""The one traffic generator: a traffic file's parameters and a seed in,
a fixed list of work items out.

Every seed gets the same multiset of sizes and of inter-arrival gaps, in
its own order: sizes and gaps are the distributions' quantiles at
stratified probabilities ``(i + 0.5) / n``, shuffled by the seed.  So two
seeds differ in which request comes when and in their token ids, never
in how much work the window holds.  Token ids are drawn by the seed over
the whole vocabulary.

Kinds:
  * ``open_loop``: requests due on a schedule over the window, ``rate_per_s``
    of them a second (Poisson gaps), each of one class of ``classes``
    (exactly ``round(share * n)`` of each, in the seed's order);
  * ``closed_loop``: ``clients`` callers, each sending its next request
    when the last one completes; the requests come from one list in the
    seed's order, cycled;
  * ``gemm_stream``: a list of row counts M, each issued against every
    (K, N) of ``shapes`` in order.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np

_N = NormalDist()


def _quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """The distribution's values at probabilities ``u`` (clipped to its
    ``min``/``max``), as integers."""
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([_N.inv_cdf(float(p)) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        x = dist["min"] + u * (dist["max"] - dist["min"])
    elif kind == "mix":
        # Parts take consecutive slices of the probability axis.
        x = np.empty(len(u))
        lo = 0.0
        for part in dist["parts"]:
            hi = lo + part["share"]
            sel = (u >= lo) & (u < hi) if hi < 1.0 else (u >= lo)
            x[sel] = _quantile(part, (u[sel] - lo) / part["share"])
            lo = hi
        return x.astype(np.int64)
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def stratified(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values of ``dist`` at stratified probabilities, in the
    order ``rng`` shuffles them."""
    u = (np.arange(n) + 0.5) / n
    return rng.permutation(_quantile(dist, u))


@dataclasses.dataclass
class Item:
    """One request: due time (open loop; seconds from the window's
    start), class, prompt ids and output length."""
    due: float
    cls: str
    tokens: np.ndarray  # (1, prompt_len) int64
    max_new: int


def _requests(classes: list[dict], n: int, vocab: int,
              rng: np.random.Generator) -> list[Item]:
    counts = [round(c["share"] * n) for c in classes]
    counts[-1] = n - sum(counts[:-1])
    kinds, prompts, outs = [], [], []
    for c, k in zip(classes, counts):
        kinds += [c["name"]] * k
        prompts.append(stratified(c["prompt"], k, rng))
        outs.append(stratified(c["output"], k, rng))
    prompts = np.concatenate(prompts)
    outs = np.concatenate(outs)
    order = rng.permutation(n)
    items = []
    for i in order:
        s = int(prompts[i])
        toks = rng.integers(0, vocab, size=(1, s), dtype=np.int64)
        items.append(Item(0.0, kinds[i], toks, int(outs[i])))
    return items


def open_loop(traffic: dict, seconds: float, vocab: int,
              seed: int) -> list[Item]:
    """The requests due in a window of ``seconds``: ``n = round(rate *
    seconds)`` of them, the exponential gaps' stratified quantiles in the
    seed's order, scaled so the n-th is due at the window's end."""
    rng = np.random.default_rng(seed)
    n = max(1, round(traffic["rate_per_s"] * seconds))
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u))
    due = np.cumsum(gaps)
    due *= seconds / due[-1]
    items = _requests(traffic["classes"], n, vocab, rng)
    for it, t in zip(items, due):
        it.due = float(t)
    return items


def closed_loop(traffic: dict, n: int, vocab: int, seed: int) -> list[Item]:
    """``n`` requests in the seed's order (the callers take them in turn);
    ``due`` is unused."""
    rng = np.random.default_rng(seed)
    return _requests(traffic["classes"], n, vocab, rng)


def gemm_rows(traffic: dict, n_cycles: int, seed: int) -> np.ndarray:
    """``n_cycles`` cycles of ``cycle`` row counts, each cycle the same
    stratified multiset in its own seed-shuffled order."""
    rng = np.random.default_rng(seed)
    k = traffic["cycle"]
    ms = [stratified(traffic["m"], k, rng) for _ in range(n_cycles)]
    m = np.concatenate(ms)
    return np.clip(m, traffic["m_min"], traffic["m_max"])


__all__ = ["Item", "open_loop", "closed_loop", "gemm_rows", "stratified"]
