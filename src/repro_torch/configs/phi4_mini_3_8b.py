"""phi4-mini-3.8b [dense]: RoPE + SwiGLU + GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
[arXiv:2412.08905; hf]

A copy of src/repro/configs/phi4_mini_3_8b.py.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE = ModelConfig(
    name="phi4-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=6,          # 24H -> 6H keeps the non-16-divisible head count
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="rmsnorm",
    act="swiglu",
    scan_chunk=16,
)
