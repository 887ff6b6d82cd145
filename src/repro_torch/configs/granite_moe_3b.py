"""granite-moe-3b-a800m [moe]: 40 experts top-8, narrow experts.

32L, d_model=1536, 24H (GQA kv=8), expert d_ff=512, vocab=49155
[hf:ibm-granite/granite-3.0 family].
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=40, experts_per_token=8, group_size=512),
    tie_embeddings=True,
)

SMOKE_CONFIG = reduced(CONFIG)
