"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 pattern.

38L, d_model=4096, 16H (GQA kv=1 i.e. MQA for the local-attn layers),
d_ff=12288, vocab=256000 [arXiv:2402.19427]. Pattern
(rglru, rglru, local): 12 scanned super-blocks + 2 unrolled tail layers.
Sub-quadratic (local window 2048) => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    tie_embeddings=True,
)

SMOKE_CONFIG = reduced(CONFIG, num_kv_heads=1)
