"""deepseek-v2-lite [moe]: multi-head latent attention, 64 fine-grained
experts top-6 with 2 shared, a dense first layer.

27L, d_model=2048, 16H of MLA (kv_lora_rank 512, qk 128 + 64 RoPE, v
128, no q LoRA, YaRN factor 40 over 4096 original positions), layer 0 a
dense SwiGLU of 10944, layers 1-26 64 routed experts of 1408 top-6 by a
softmax whose gates are not renormalized, plus 2 shared experts (one
SwiGLU of 2816), vocab=102400, untied head
[hf:deepseek-ai/DeepSeek-V2-Lite]. Routing is the port's GShard rule
(groups of 512, capacity factor 1.25), not the published dropless one.

Not in ``configs.ARCHS``: ``repro`` has no latent attention, so no
parity test holds this config against it; ``get_config`` finds it.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=128,
    block_pattern=("mla",),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128, rope_factor=40.0,
                  rope_original_max_position=4096, rope_beta_fast=32.0,
                  rope_beta_slow=1.0, rope_mscale=0.707,
                  rope_mscale_all_dim=0.707),
    moe=MoEConfig(num_experts=64, experts_per_token=6, shared_expert=True,
                  group_size=512),
    shared_d_ff=2816,
    norm_topk_prob=False,
    first_dense_layers=1,
    dense_d_ff=10944,
    tie_embeddings=False,
)

# 1 dense + 2 MoE layers, 8 experts top-2, small ranks; YaRN over 32
# original positions so that a CPU test's prompts reach past them
SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    head_dim=16,
    block_pattern=("mla",),
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16, rope_factor=4.0,
                  rope_original_max_position=32, rope_beta_fast=32.0,
                  rope_beta_slow=1.0, rope_mscale=0.707,
                  rope_mscale_all_dim=0.707),
    moe=MoEConfig(num_experts=8, experts_per_token=2, shared_expert=True,
                  group_size=16),
    shared_d_ff=64,
    norm_topk_prob=False,
    first_dense_layers=1,
    dense_d_ff=96,
    tie_embeddings=False,
)
