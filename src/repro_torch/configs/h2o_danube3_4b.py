"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window 4096.
SWA makes decode memory/compute bounded by the window -> eligible for
long_500k. [arXiv:2401.16818; unverified]

A copy of src/repro/configs/h2o_danube3_4b.py.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    pattern=(LayerSpec(mixer="attn", mlp="dense", window=4096),),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=True,  # sliding-window attention
)

SMOKE = ModelConfig(
    name="danube-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    pattern=(LayerSpec(mixer="attn", mlp="dense", window=16),),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=True,
    scan_chunk=16,
)
