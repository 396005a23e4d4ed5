"""whisper-small [audio]: enc-dec backbone; conv frontend STUBBED.

12L (decoder) + 12L encoder, d_model=768 12H d_ff=3072 vocab=51865.
The encoder takes precomputed frame embeddings (b, 1500, d); the server
feeds zeros, as the reference's frontend stub does.  Sinusoidal positions
(no RoPE), LayerNorm, GELU.
[arXiv:2212.04356; unverified]

A copy of src/repro/configs/whisper_small.py.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    pattern=(LayerSpec(mixer="attn", mlp="dense", cross_attn=True),),
    norm="layernorm",
    act="gelu",
    use_rope=False,
    tie_embeddings=True,
    encoder_decoder=True,
    n_encoder_layers=12,
    encoder_seq=1500,
    sub_quadratic=False,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    pattern=(LayerSpec(mixer="attn", mlp="dense", cross_attn=True),),
    norm="layernorm",
    act="gelu",
    use_rope=False,
    encoder_decoder=True,
    n_encoder_layers=2,
    encoder_seq=32,
    scan_chunk=16,
)
