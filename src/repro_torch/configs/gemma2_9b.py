"""gemma2-9b [dense]: local+global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim 256,
GeGLU, RMSNorm, sqrt(d) embedding scaling, attn softcap 50, final softcap 30,
local layers use a 4096 sliding window. [arXiv:2408.00118; hf]

A copy of src/repro/configs/gemma2_9b.py.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    pattern=(
        LayerSpec(mixer="attn", mlp="dense", window=4096),  # local
        LayerSpec(mixer="attn", mlp="dense", window=None),  # global
    ),
    norm="rmsnorm",
    act="geglu",
    attn_softcap=50.0,
    logit_softcap=30.0,
    embed_scale=True,
    tie_embeddings=True,
    # Global layers are full-context -> NOT eligible for long_500k.
    sub_quadratic=False,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    pattern=(
        LayerSpec(mixer="attn", mlp="dense", window=16),
        LayerSpec(mixer="attn", mlp="dense", window=None),
    ),
    norm="rmsnorm",
    act="geglu",
    attn_softcap=50.0,
    logit_softcap=30.0,
    embed_scale=True,
    scan_chunk=16,
)
