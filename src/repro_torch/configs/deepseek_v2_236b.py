"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff_expert=1536 vocab=102400.
[arXiv:2405.04434; hf]

A copy of src/repro/configs/deepseek_v2_236b.py.
"""
from repro_torch.models.config import LayerSpec, MLASpec, MoESpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head latent KV (cache stores the 512-d latent)
    d_ff=1536,
    vocab=102400,
    pattern=(LayerSpec(mixer="mla", mlp="moe"),),
    moe=MoESpec(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2),
    mla=MLASpec(
        kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    ),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    sub_quadratic=False,  # MLA compresses the cache; attention is full-context
    fsdp=True,            # 236B: the reference shards params over 'data'
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab=512,
    pattern=(LayerSpec(mixer="mla", mlp="moe"),),
    moe=MoESpec(num_experts=8, top_k=2, d_ff_expert=64, num_shared=1),
    mla=MLASpec(
        kv_lora_rank=32, q_lora_rank=48,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    ),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=False,
    scan_chunk=16,
)
