"""falcon-mamba-7b [ssm]: attention-free Mamba-1.

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16, d_inner=8192.
Pure SSM -> decode state is O(1) in context length; long_500k runs.
[arXiv:2410.05355; unverified]

A copy of src/repro/configs/falcon_mamba_7b.py.
"""
from repro_torch.models.config import LayerSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    pattern=(LayerSpec(mixer="mamba", mlp="none"),),
    ssm=SSMSpec(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=True,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    pattern=(LayerSpec(mixer="mamba", mlp="none"),),
    ssm=SSMSpec(d_inner=128, d_state=8, d_conv=4, dt_rank=8),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=True,
    scan_chunk=16,
)
