"""Weights from the seed, drawn on the card in the type they are served
in, one large call per stacked leaf.

The tree is laid out as the port consumes it (``embed``, ``final_norm``,
``lm_head`` where the embedding is not tied, and ``pos0`` ...
``pos{P-1}``, one per position of the layer pattern, with every leaf
stacked over the pattern's repetitions on a leading axis); the reference
reads the same names.  Calling :func:`draw` twice with one seed gives the
same bits, so the reference redraws its own copy after the program is
gone rather than reading the program's.

Matrices are normal with std fan_in^-1/2.  Constant leaves are what the
port initialises them to: norms and Mamba's ``D`` ones, biases zeros,
Mamba's ``A_log`` log(1..d_state) over each channel.
"""
from __future__ import annotations

import math

import torch

from kit import layout

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _mixer(model: dict, mixer: str, G: int) -> list[tuple]:
    d, dt = model["d_model"], model["dtype"]
    if mixer == "attn":
        h, kv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
        return [
            ("wq", (G, d, h * hd), dt, d),
            ("wk", (G, d, kv * hd), dt, d),
            ("wv", (G, d, kv * hd), dt, d),
            ("wo", (G, h * hd, d), dt, h * hd),
        ]
    if mixer == "mamba":
        s = model["ssm"]
        di, ds, dc, dtr = s["d_inner"], s["d_state"], s["d_conv"], \
            s["dt_rank"]
        return [
            ("in_proj", (G, d, 2 * di), dt, d),
            ("conv_w", (G, dc, di), dt, dc),
            ("conv_b", (G, di), dt, "zeros"),
            ("x_proj", (G, di, dtr + 2 * ds), dt, di),
            ("dt_proj", (G, dtr, di), dt, dtr),
            ("dt_bias", (G, di), dt, "zeros"),
            ("A_log", (G, di, ds), "float32", "ssm_a"),
            ("D", (G, di), "float32", None),
            ("out_proj", (G, di, d), dt, di),
        ]
    m, h = model["mla"], model["n_heads"]
    c, qr, nope, rope, dv = (m["kv_lora_rank"], m["q_lora_rank"],
                             m["qk_nope_dim"], m["qk_rope_dim"],
                             m["v_head_dim"])
    return [
        ("wdq", (G, d, qr), dt, d),
        ("q_norm", (G, qr), dt, None),
        ("wuq", (G, qr, h * (nope + rope)), dt, qr),
        ("wdkv", (G, d, c + rope), dt, d),
        ("kv_norm", (G, c), dt, None),
        ("wuk", (G, c, h * nope), dt, c),
        ("wuv", (G, c, h * dv), dt, c),
        ("wo", (G, h * dv, d), dt, h * dv),
    ]


def _mlp(model: dict, mlp: str, G: int) -> list[tuple]:
    d, dt = model["d_model"], model["dtype"]
    if mlp == "dense":
        f = model["d_ff"]
        return [
            ("w_in", (G, d, f), dt, d),
            ("w_gate", (G, d, f), dt, d),
            ("w_out", (G, f, d), dt, f),
        ]
    moe = model["moe"]
    e, fe = moe["num_experts"], moe["d_ff_expert"]
    out = [
        ("router", (G, d, e), "float32", d),
        ("w_in", (G, e, d, fe), dt, d),
        ("w_gate", (G, e, d, fe), dt, d),
        ("w_out", (G, e, fe, d), dt, fe),
    ]
    fs = layout.num_shared(model) * fe
    if fs:
        out += [
            ("shared_in", (G, d, fs), dt, d),
            ("shared_gate", (G, d, fs), dt, d),
            ("shared_out", (G, fs, d), dt, fs),
        ]
    return out


def leaves(model: dict) -> list[tuple[str, tuple, str, int | str | None]]:
    """(path, shape, dtype, init), in the order they are drawn: the init
    is the fan-in of a normal leaf, None for a leaf of ones, or the name
    of another constant (``"zeros"``, ``"ssm_a"``)."""
    d, dt = model["d_model"], model["dtype"]
    G = layout.n_groups(model)
    out = [
        ("embed", (model["vocab_padded"], d), dt, d),
        ("final_norm", (d,), dt, None),
    ]
    if not model["tie_embeddings"]:
        out.append(("lm_head", (d, model["vocab_padded"]), dt, d))
    for i, spec in enumerate(layout.pattern(model)):
        pos = f"pos{i}"
        out.append((f"{pos}/norm_mixer", (G, d), dt, None))
        if spec["mlp"] != "none":
            out.append((f"{pos}/norm_mlp", (G, d), dt, None))
        out += [(f"{pos}/{spec['mixer']}/{n}", *rest)
                for n, *rest in _mixer(model, spec["mixer"], G)]
        if spec["mlp"] != "none":
            sub = "moe" if spec["mlp"] == "moe" else "mlp"
            out += [(f"{pos}/{sub}/{n}", *rest)
                    for n, *rest in _mlp(model, spec["mlp"], G)]
    return out


def _constant(init: str | None, shape: tuple, dtype, device) -> torch.Tensor:
    if init is None:
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ssm_a":
        # log(1..d_state), taken in float64 (correctly rounded), as the
        # port's S4D-real init.
        a = torch.arange(1, shape[-1] + 1, dtype=torch.float64,
                         device=device)
        return torch.log(a).expand(shape).to(dtype).contiguous()
    raise ValueError(f"unknown constant init {init!r}")


def draw(model: dict, seed: int, device) -> dict:
    """The nested weight tree for ``model`` from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tree: dict = {}
    for path, shape, dt, init in leaves(model):
        dtype = _DTYPES[dt]
        if init is None or isinstance(init, str):
            t = _constant(init, shape, dtype, device)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            t.mul_(1.0 / math.sqrt(init))
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
