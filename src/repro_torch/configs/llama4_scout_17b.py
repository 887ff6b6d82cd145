"""llama4-scout-17b-a16e [moe]: 16 experts top-1 + shared expert.

48L, d_model=5120, 40H (GQA kv=8), expert d_ff=8192, vocab=202048,
early-fusion vision stub [hf:meta-llama/Llama-4-Scout-17B-16E].
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    moe=MoEConfig(num_experts=16, experts_per_token=1,
                  shared_expert=True, group_size=512),
    num_source_positions=576,   # early-fusion vision stub
)

SMOKE_CONFIG = reduced(CONFIG)
