"""command-r-plus-104b [dense]: GQA, no biases. The largest assigned arch.

64L, d_model=12288, 96H (GQA kv=8), d_ff=33792, vocab=256000
[hf:CohereForAI/c4ai-command-r-plus]. Requires TP+FSDP to fit.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
)

SMOKE_CONFIG = reduced(CONFIG)
