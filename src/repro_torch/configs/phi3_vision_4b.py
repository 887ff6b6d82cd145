"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP stub.

32L, d_model=3072, 32H (kv=32), d_ff=8192, vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct]. CLIP frontend is a stub:
``input_specs`` provides precomputed patch embeddings (576 patches),
early-fused over the first token positions.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    num_source_positions=576,
)

SMOKE_CONFIG = reduced(CONFIG)
