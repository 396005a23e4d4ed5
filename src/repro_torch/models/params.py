"""Parameter schema, seeded init, and the bridge from the JAX package.

The schema mirrors src/repro/models/params.py for models whose mixers
are attention (with cross-attention in whisper's decoder), MLA or Mamba,
with dense, MoE or no MLPs, and whisper's encoder stack: a nested dict of
:class:`ParamDef` whose per-layer leaves are stacked over ``n_groups``
(the reference's scan layout), so a parameter tree of one package maps
onto the other's leaf for leaf.

* :func:`init_params` draws the weights from an explicit
  :class:`torch.Generator`, one leaf at a time on the generator's device
  (normal, std = fan_in^-1/2, as the reference, save that an expert
  stack's fan-in is its input width, not the expert count).  ``zeros``,
  ``ones`` and ``ssm_a`` (Mamba's A_log = log(1..d_state) over d_inner)
  leaves are constants, as in the reference.
  The draws differ from ``jax.random``'s; cross-package tests carry the
  reference's own weights over with :func:`params_from_numpy` instead.
* :func:`params_from_numpy` takes the reference ``init_params`` tree as
  numpy arrays (stacked ``(n_groups, ...)`` leaves included), checks every
  shape against the schema and moves it to ``device``.
* :func:`param_pspecs` is the same tree of PartitionSpecs: each leaf's
  logical axes (the reference's, a stacked leaf's led by ``"layers"``)
  through ``AxisRules.spec_for``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.config import LayerSpec, ModelConfig

__all__ = [
    "ParamDef",
    "model_schema",
    "init_params",
    "abstract_params",
    "params_from_numpy",
    "decay_mask",
    "param_pspecs",
    "count_params",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative definition of one parameter tensor."""

    shape: tuple[int, ...]
    logical: tuple[str | None, ...]  # one logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | ssm_a
    dtype: str = "bfloat16"
    scale_axis: int = 0  # fan-in axis for the normal init scale
    stacked: int = 0  # leading axes that stack layers (see _stack)

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical axes "
                             f"{self.logical}")


Schema = dict[str, Any]  # nested dict of ParamDef


def _attn_schema(cfg: ModelConfig, spec: LayerSpec) -> Schema:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qdim, kvdim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    dt = cfg.dtype
    s: Schema = {
        "wq": ParamDef((d, qdim), ("embed", "q_heads"), dtype=dt),
        "wk": ParamDef((d, kvdim), ("embed", "kv_heads"), dtype=dt),
        "wv": ParamDef((d, kvdim), ("embed", "kv_heads"), dtype=dt),
        "wo": ParamDef((qdim, d), ("q_heads", "embed"), dtype=dt),
    }
    if spec.cross_attn:
        # Whisper's decoder attends to the encoder output after its
        # self-attention (src/repro/models/params.py:68-76).
        s.update({
            "xq": ParamDef((d, qdim), ("embed", "q_heads"), dtype=dt),
            "xk": ParamDef((d, kvdim), ("embed", "kv_heads"), dtype=dt),
            "xv": ParamDef((d, kvdim), ("embed", "kv_heads"), dtype=dt),
            "xo": ParamDef((qdim, d), ("q_heads", "embed"), dtype=dt),
            "norm_x": ParamDef((d,), (None,), init="ones", dtype=dt),
        })
    return s


def _mla_schema(cfg: ModelConfig) -> Schema:
    m = cfg.mla
    if m is None:
        raise ValueError(f"{cfg.name}: an 'mla' layer needs cfg.mla")
    d, h = cfg.d_model, cfg.n_heads
    dt = cfg.dtype
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wdq": ParamDef((d, m.q_lora_rank), ("embed", None), dtype=dt),
        "wuq": ParamDef((m.q_lora_rank, h * qk), (None, "q_heads"),
                        dtype=dt),
        "q_norm": ParamDef((m.q_lora_rank,), (None,), init="ones",
                           dtype=dt),
        "wdkv": ParamDef((d, m.kv_lora_rank + m.qk_rope_dim),
                         ("embed", None), dtype=dt),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones",
                            dtype=dt),
        "wuk": ParamDef((m.kv_lora_rank, h * m.qk_nope_dim),
                        (None, "q_heads"), dtype=dt),
        "wuv": ParamDef((m.kv_lora_rank, h * m.v_head_dim),
                        (None, "q_heads"), dtype=dt),
        "wo": ParamDef((h * m.v_head_dim, d), ("q_heads", "embed"),
                       dtype=dt),
    }


def _mamba_schema(cfg: ModelConfig) -> Schema:
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name}: a 'mamba' layer needs cfg.ssm")
    d = cfg.d_model
    dtr = s.dt_rank or d // 16
    dt = cfg.dtype
    return {
        "in_proj": ParamDef((d, 2 * s.d_inner), ("embed", "ssm_inner"),
                            dtype=dt),
        "conv_w": ParamDef((s.d_conv, s.d_inner), (None, "ssm_inner"),
                           dtype=dt),
        "conv_b": ParamDef((s.d_inner,), ("ssm_inner",), init="zeros",
                           dtype=dt),
        "x_proj": ParamDef((s.d_inner, dtr + 2 * s.d_state),
                           ("ssm_inner", None), dtype=dt),
        "dt_proj": ParamDef((dtr, s.d_inner), (None, "ssm_inner"),
                            dtype=dt),
        "dt_bias": ParamDef((s.d_inner,), ("ssm_inner",), init="zeros",
                            dtype=dt),
        # A_log/D stay f32: the recurrence decay must not round to 1.0 in
        # bf16.
        "A_log": ParamDef((s.d_inner, s.d_state), ("ssm_inner", None),
                          init="ssm_a", dtype="float32"),
        "D": ParamDef((s.d_inner,), ("ssm_inner",), init="ones",
                      dtype="float32"),
        "out_proj": ParamDef((s.d_inner, d), ("ssm_inner", "embed"),
                             dtype=dt),
    }


def _mlp_schema(cfg: ModelConfig) -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.dtype
    s: Schema = {
        "w_in": ParamDef((d, f), ("embed", "ff"), dtype=dt),
        "w_out": ParamDef((f, d), ("ff", "embed"), dtype=dt),
    }
    if cfg.act in ("swiglu", "geglu"):
        s["w_gate"] = ParamDef((d, f), ("embed", "ff"), dtype=dt)
    return s


def _moe_schema(cfg: ModelConfig) -> Schema:
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name}: an 'moe' layer needs cfg.moe")
    d, fe, E = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = cfg.dtype
    s: Schema = {
        # Router in f32: tiny, and routing decisions are precision-sensitive.
        "router": ParamDef((d, E), ("embed", None), dtype="float32"),
        # Expert stacks: the init's fan-in is each expert's input width
        # (axis 1).  The reference leaves axis 0, the expert count, which
        # makes seeded expert outputs ~sqrt(d / E) too large (ROADMAP C2).
        "w_in": ParamDef((E, d, fe), ("expert", "embed", None), dtype=dt,
                         scale_axis=1),
        "w_out": ParamDef((E, fe, d), ("expert", None, "embed"), dtype=dt,
                          scale_axis=1),
    }
    if cfg.act in ("swiglu", "geglu"):
        s["w_gate"] = ParamDef((E, d, fe), ("expert", "embed", None),
                               dtype=dt, scale_axis=1)
    if m.num_shared:
        f_sh = m.num_shared * fe
        s["shared_in"] = ParamDef((d, f_sh), ("embed", "ff"), dtype=dt)
        s["shared_out"] = ParamDef((f_sh, d), ("ff", "embed"), dtype=dt)
        if cfg.act in ("swiglu", "geglu"):
            s["shared_gate"] = ParamDef((d, f_sh), ("embed", "ff"),
                                          dtype=dt)
    return s


def _layer_schema(cfg: ModelConfig, spec: LayerSpec) -> Schema:
    dt = cfg.dtype
    s: Schema = {
        "norm_mixer": ParamDef((cfg.d_model,), (None,), init="ones",
                               dtype=dt),
    }
    if spec.mixer == "attn":
        s["attn"] = _attn_schema(cfg, spec)
    elif spec.mixer == "mla":
        s["mla"] = _mla_schema(cfg)
    elif spec.mixer == "mamba":
        s["mamba"] = _mamba_schema(cfg)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.mlp != "none":
        s["norm_mlp"] = ParamDef((cfg.d_model,), (None,), init="ones",
                                  dtype=dt)
        if spec.mlp == "dense":
            s["mlp"] = _mlp_schema(cfg)
        else:
            s["moe"] = _moe_schema(cfg)
    return s


def _stack(schema: Schema, n: int) -> Schema:
    """Prepend a stacked 'layers' axis of size n to every ParamDef."""
    out: Schema = {}
    for k, v in schema.items():
        if isinstance(v, ParamDef):
            out[k] = ParamDef(
                shape=(n,) + v.shape, logical=("layers",) + v.logical,
                init=v.init, dtype=v.dtype,
                scale_axis=v.scale_axis + 1, stacked=v.stacked + 1,
            )
        else:
            out[k] = _stack(v, n)
    return out


def model_schema(cfg: ModelConfig) -> Schema:
    """Full parameter schema for one architecture: with
    ``encoder_decoder``, an ``encoder`` subtree of ``n_encoder_layers``
    stacked attention + dense-MLP layers and their final norm."""
    dt = cfg.dtype
    s: Schema = {
        "embed": ParamDef((cfg.vocab_padded, cfg.d_model),
                          ("vocab", "embed"), dtype=dt),
        "final_norm": ParamDef((cfg.d_model,), (None,), init="ones",
                               dtype=dt),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_padded),
                                ("embed", "vocab"), dtype=dt)
    for p, spec in enumerate(cfg.pattern):
        s[f"pos{p}"] = _stack(_layer_schema(cfg, spec), cfg.n_groups)
    if cfg.encoder_decoder:
        enc_layer = _layer_schema(cfg, LayerSpec(mixer="attn", mlp="dense"))
        s["encoder"] = {
            "layers": _stack(enc_layer, cfg.n_encoder_layers),
            "final_norm": ParamDef((cfg.d_model,), (None,), init="ones",
                                   dtype=dt),
        }
    return s


def _leaves(schema: Schema, prefix: str = "") -> list[tuple[str, ParamDef]]:
    out = []
    for k, v in sorted(schema.items()):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, ParamDef):
            out.append((path, v))
        else:
            out.extend(_leaves(v, path))
    return out


def _map_schema(
    schema: Schema, fn: Callable[[str, ParamDef], Any], prefix: str = ""
) -> Any:
    out = {}
    for k, v in schema.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = fn(path, v) if isinstance(v, ParamDef) else _map_schema(
            v, fn, path
        )
    return out


def init_params(
    cfg: ModelConfig, generator: torch.Generator, device="cuda"
) -> dict:
    """Seeded weights, one leaf at a time: each normal leaf is drawn in f32
    on ``generator``'s device (in sorted path order, so the draw is
    independent of dict order), scaled by fan_in^-1/2, cast, and moved to
    ``device`` before the next leaf is drawn.  The transient f32 draw is
    the only extra memory, so a 9B-parameter model never sits whole in f32
    anywhere.  A CPU generator gives the same weights on every device; a
    CUDA generator draws on the card (other numbers from the same seed).
    Constant leaves draw nothing."""
    schema = model_schema(cfg)
    drawn: dict[str, torch.Tensor] = {}
    for path, d in _leaves(schema):
        dtype = _DTYPES[d.dtype]
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dtype, device=device)
        elif d.init == "ssm_a":
            # Mamba's S4D-real init: A = -(1..d_state), broadcast over
            # d_inner, stored as its log (taken in float64: correctly
            # rounded; XLA's float32 log is off by an ulp at some n).
            a = torch.arange(1, d.shape[-1] + 1, dtype=torch.float64,
                             device=device)
            t = torch.log(a).expand(d.shape).to(dtype).contiguous()
        else:
            fan_in = d.shape[d.scale_axis]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            t = torch.randn(d.shape, generator=generator,
                            device=generator.device)
            t = t.mul_(std).to(dtype=dtype, device=device)
        drawn[path] = t
    return _map_schema(schema, lambda p, d: drawn[p])


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as ``device="meta"`` tensors: each leaf's shape
    and dtype, no storage (the dry run's stand-in; the reference's
    ``abstract_params``, src/repro/models/params.py:279)."""
    return _map_schema(
        model_schema(cfg),
        lambda _, d: torch.empty(d.shape, dtype=_DTYPES[d.dtype],
                                 device="meta"),
    )


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The JAX package's parameter tree (``init_params`` leaves turned into
    numpy arrays) as a torch tree on ``device``, leaf for leaf.  bfloat16
    leaves (numpy's ``ml_dtypes`` bfloat16) cross through float32, which
    holds every bfloat16 value exactly."""

    def convert(path: str, d: ParamDef) -> torch.Tensor:
        node = tree
        for key in path.split("/"):
            node = node[key]
        arr = np.asarray(node)
        if tuple(arr.shape) != d.shape:
            raise ValueError(
                f"{path}: shape {arr.shape} != schema {d.shape}"
            )
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))  # an owned, writable copy
        return t.to(dtype=_DTYPES[d.dtype], device=device)

    return _map_schema(model_schema(cfg), convert)


def decay_mask(cfg: ModelConfig) -> dict:
    """Which leaves AdamW decays: those of rank >= 2 BEFORE stacking, the
    matrices of each layer, the embedding and the head.  The reference
    tests the stacked rank (src/repro/optim/adamw.py:88-90), which also
    decays every layer's norm gains and Mamba's ``conv_b``, ``dt_bias``
    and ``D`` (ROADMAP C14)."""
    return _map_schema(model_schema(cfg),
                       lambda _, d: len(d.shape) - d.stacked >= 2)


def param_pspecs(cfg: ModelConfig, rules) -> dict:
    """The PartitionSpec of every parameter leaf under ``rules`` (an
    ``AxisRules``), sanitized against its shape."""
    return _map_schema(model_schema(cfg),
                       lambda _, d: rules.spec_for(d.shape, d.logical))


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count from the schema."""
    return sum(int(np.prod(d.shape)) for _, d in _leaves(model_schema(cfg)))
