"""The layer pattern a configuration file states.

A file's ``model`` may carry ``"pattern"``: one entry per position of the
repeating period, ``{"mixer": "attn" | "mamba" | "mla", "mlp": "dense" |
"moe" | "none"}``, laid out as the port's ``ModelConfig.pattern``; the
model is ``n_layers / len(pattern)`` repetitions of it.  A Mamba mixer
reads the file's ``ssm`` (``d_inner``, ``d_state``, ``d_conv``,
``dt_rank``), an MLA mixer its ``mla`` (``kv_lora_rank``,
``q_lora_rank``, ``qk_nope_dim``, ``qk_rope_dim``, ``v_head_dim``), an MoE
MLP its ``moe`` (``num_shared`` shared experts beside the routed ones, 0
when absent).  A file without ``pattern`` means one attention position
whose MLP is MoE when the file has ``moe``, dense otherwise.

Three keys state kinds of layer that some published models have and the
port may lack; the plain reference follows them, and ``check_widths``
holds the port to them:

* ``model["attn_rope"]``: false where attention has no positional
  encoding (true, RoPE at ``rope_theta``, when absent);
* ``ssm["inner_norms"]``: true where Mamba takes an RMSNorm (unit weight)
  of dt, B and C before the scan (false when absent);
* ``moe["capacity_factor"]``: null where the experts are dropless.
"""
from __future__ import annotations

MIXERS = ("attn", "mamba", "mla")
MLPS = ("dense", "moe", "none")


def pattern(model: dict) -> list[dict]:
    """The period's positions, each ``{"mixer", "mlp"}``."""
    if "pattern" not in model:
        return [{"mixer": "attn", "mlp": "moe" if model.get("moe")
                 else "dense"}]
    out = []
    for spec in model["pattern"]:
        if spec["mixer"] not in MIXERS or spec["mlp"] not in MLPS:
            raise ValueError(f"unknown layer kind {spec!r}")
        out.append({"mixer": spec["mixer"], "mlp": spec["mlp"]})
    return out


def n_groups(model: dict) -> int:
    """Repetitions of the period: ``n_layers / len(pattern)``."""
    period = len(pattern(model))
    if model["n_layers"] % period:
        raise ValueError(f"{model['n_layers']} layers do not hold whole "
                         f"periods of {period}")
    return model["n_layers"] // period


def layers_of(model: dict, mixer: str) -> int:
    """How many of the model's layers have this mixer."""
    return n_groups(model) * sum(p["mixer"] == mixer for p in pattern(model))


def num_shared(model: dict) -> int:
    moe = model.get("moe")
    return int(moe.get("num_shared", 0)) if moe else 0
