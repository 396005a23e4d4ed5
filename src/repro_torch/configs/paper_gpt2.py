"""The paper's own model-level evaluation target (GPT-2 class, ~124M).

The paper (§7.3) evaluates BERT/BERT-large/GPT-2 under dynamic sequence
lengths.  This is the GPT-2-small-scale decoder the serving entry point
(launch/serve.py) runs by default, a copy of src/repro/configs/
paper_gpt2.py.  RoPE replaces learned positions, as in the JAX package.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="paper-gpt2-124m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=50257,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE = ModelConfig(
    name="paper-gpt2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    pattern=(LayerSpec(mixer="attn", mlp="dense"),),
    norm="layernorm",
    act="gelu",
    scan_chunk=16,
)
