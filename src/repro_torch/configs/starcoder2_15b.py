"""starcoder2-15b [dense]: GQA + RoPE, LayerNorm, plain-GELU MLP.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
[arXiv:2402.19173; hf]

A copy of src/repro/configs/starcoder2_15b.py.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    sub_quadratic=False,
    fsdp=True,  # 15B: shard params+opt over 'data' to keep HBM headroom
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="layernorm",
    act="gelu",
    scan_chunk=16,
)
