"""internvl2-26b [vlm]: InternViT frontend (STUB) + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The ViT frontend
is stubbed: precomputed patch embeddings overwrite the first vision_prefix
positions (the server feeds zeros, as the reference's frontend stub does).
[arXiv:2404.16821; hf]

A copy of src/repro/configs/internvl2_26b.py.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    vision_prefix=256,  # patch embeddings prepended (frontend stub)
    sub_quadratic=False,
    fsdp=True,  # 26B
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    vision_prefix=8,
    scan_chunk=16,
)
