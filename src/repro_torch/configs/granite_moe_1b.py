"""granite-moe-1b-a400m [moe]: 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff_expert=512 vocab=49155, a copy of
src/repro/configs/granite_moe_1b.py.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.models.config import LayerSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    moe=MoESpec(num_experts=32, top_k=8, d_ff_expert=512),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab=512,
    pattern=(LayerSpec(mixer="attn", mlp="moe"),),
    moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=64),
    norm="rmsnorm",
    act="swiglu",
    scan_chunk=16,
)
