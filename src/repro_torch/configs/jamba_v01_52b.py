"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave + MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Each 8-layer Jamba
block has one attention layer (index 4) and seven Mamba layers; MoE replaces
the dense MLP on every other layer. [arXiv:2403.19887; hf]

A copy of src/repro/configs/jamba_v01_52b.py.
"""
from repro_torch.models.config import LayerSpec, MoESpec, ModelConfig, SSMSpec


def _jamba_pattern() -> tuple[LayerSpec, ...]:
    out = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        out.append(LayerSpec(mixer=mixer, mlp=mlp))
    return tuple(out)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=_jamba_pattern(),
    moe=MoESpec(num_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMSpec(d_inner=8192, d_state=16, d_conv=4, dt_rank=256),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=True,  # 1:7 attn:mamba -> cache grows only on 4/32 layers
    fsdp=True,           # 52B
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    pattern=_jamba_pattern(),
    moe=MoESpec(num_experts=4, top_k=2, d_ff_expert=128),
    ssm=SSMSpec(d_inner=128, d_state=8, d_conv=4, dt_rank=8),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=True,
    scan_chunk=16,
)
