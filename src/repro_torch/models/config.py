"""Model/shape configuration schema for all assigned architectures.

A copy of the JAX package's schema (src/repro/models/config.py), so a
config means the same model on both sides.  A model is a repeated
``pattern`` of :class:`LayerSpec`s (mixer + mlp kind); parameters are
stacked per pattern position over pattern repetitions.  This package runs
the dense attention decoders; the MoE/SSM/MLA fields are carried as data
for the architectures of later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["LayerSpec", "MoESpec", "SSMSpec", "MLASpec", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """DeepSeek-V2 multi-head latent attention dims."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position within the repeating pattern."""

    mixer: Literal["attn", "mla", "mamba"] = "attn"
    mlp: Literal["dense", "moe", "none"] = "dense"
    window: int | None = None  # sliding-window size for this layer's attn
    cross_attn: bool = False   # whisper decoder cross-attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0                # 0 -> d_model // n_heads
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    mla: MLASpec | None = None
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    use_rope: bool = True            # False -> sinusoidal absolute positions
    rope_theta: float = 10000.0
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scaling
    encoder_decoder: bool = False    # whisper
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper frame count (frontend stubbed)
    vision_prefix: int = 0           # internvl2: # patch embeddings prepended
    sub_quadratic: bool = False      # eligible for long_500k (SSM/hybrid/SWA)
    dtype: str = "bfloat16"
    fsdp: bool = False               # additionally shard params over 'data'
    scan_chunk: int = 256            # mamba scan remat-chunk length

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            self.name, self.n_layers, len(self.pattern))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded to a multiple of 256 (as in the JAX
        package, so weights carry across).  Logit columns >= vocab are
        masked to -1e30 in the forward pass."""
        return -(-self.vocab // 256) * 256

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for spec in self.pattern:
            n = self._layer_params(spec)
            total += n * self.n_groups
        total += d  # final norm
        if self.encoder_decoder:
            enc_layer = (4 * d * self.n_heads * self.resolved_head_dim
                         + 3 * d * self.d_ff
                         if self.act in ("swiglu", "geglu")
                         else 4 * d * d + 2 * d * self.d_ff)
            total += self.n_encoder_layers * enc_layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for spec in self.pattern:
            n = self._layer_params(spec, active=True)
            total += n * self.n_groups
        total += d
        return int(total)

    def _layer_params(self, spec: LayerSpec, active: bool = False) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        n = 2 * d  # norms
        if spec.mixer == "attn":
            n += d * self.n_heads * hd * 2  # wq, wo
            n += d * self.n_kv_heads * hd * 2  # wk, wv
            if spec.cross_attn:
                n += d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        elif spec.mixer == "mla":
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            n += d * m.q_lora_rank + m.q_lora_rank * qdim
            n += d * (m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
        elif spec.mixer == "mamba":
            s = self.ssm
            dtr = s.dt_rank or d // 16
            n += d * 2 * s.d_inner            # in_proj
            n += s.d_inner * s.d_conv         # depthwise conv
            n += s.d_inner * (dtr + 2 * s.d_state)  # x_proj
            n += dtr * s.d_inner              # dt_proj
            n += s.d_inner * s.d_state        # A_log
            n += s.d_inner * 2                # D, conv bias-ish
            n += s.d_inner * d                # out_proj
        if spec.mlp == "dense":
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            n += mult * d * self.d_ff
        elif spec.mlp == "moe":
            m = self.moe
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            experts = m.top_k if active else m.num_experts
            n += experts * mult * d * m.d_ff_expert
            n += m.num_shared * mult * d * m.d_ff_expert
            n += d * m.num_experts  # router
        return n
