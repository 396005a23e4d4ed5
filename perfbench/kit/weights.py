"""Weights from the seed, drawn on the card in the type they are served
in, one large call per stacked leaf.

The tree is laid out as the port consumes it (``embed``, ``final_norm``
and ``pos0`` with every layer's leaves stacked on a leading axis); the
reference reads the same names.  Calling :func:`draw` twice with one seed
gives the same bits, so the reference redraws its own copy after the
program is gone rather than reading the program's.
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(model: dict) -> list[tuple[str, tuple, str, int | None]]:
    """(path, shape, dtype, fan-in or None for a norm of ones), in the
    order they are drawn."""
    L, d = model["n_layers"], model["d_model"]
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    dt = model["dtype"]
    out = [
        ("embed", (model["vocab_padded"], d), dt, d),
        ("final_norm", (d,), dt, None),
        ("pos0/norm_mixer", (L, d), dt, None),
        ("pos0/norm_mlp", (L, d), dt, None),
        ("pos0/attn/wq", (L, d, h * hd), dt, d),
        ("pos0/attn/wk", (L, d, kv * hd), dt, d),
        ("pos0/attn/wv", (L, d, kv * hd), dt, d),
        ("pos0/attn/wo", (L, h * hd, d), dt, h * hd),
    ]
    moe = model.get("moe")
    if moe:
        e, fe = moe["num_experts"], moe["d_ff_expert"]
        out += [
            ("pos0/moe/router", (L, d, e), "float32", d),
            ("pos0/moe/w_in", (L, e, d, fe), dt, d),
            ("pos0/moe/w_gate", (L, e, d, fe), dt, d),
            ("pos0/moe/w_out", (L, e, fe, d), dt, fe),
        ]
    else:
        f = model["d_ff"]
        out += [
            ("pos0/mlp/w_in", (L, d, f), dt, d),
            ("pos0/mlp/w_gate", (L, d, f), dt, d),
            ("pos0/mlp/w_out", (L, f, d), dt, f),
        ]
    return out


def draw(model: dict, seed: int, device) -> dict:
    """The nested weight tree for ``model`` from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tree: dict = {}
    for path, shape, dt, fan_in in leaves(model):
        dtype = _DTYPES[dt]
        if fan_in is None:
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            t.mul_(1.0 / math.sqrt(fan_in))
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def nbytes(model: dict) -> int:
    """Bytes of the served weights."""
    size = {"bfloat16": 2, "float32": 4}
    return sum(math.prod(shape) * size[dt]
               for _, shape, dt, _ in leaves(model))
