"""xlstm-350m [ssm]: alternating mLSTM / sLSTM blocks.

24L, d_model=1024, 4H, d_ff=0 (no separate FFN sublayer; the xLSTM blocks
carry the capacity), vocab=50304 [arXiv:2405.04517]. Pattern
(mlstm, slstm) x 12. Fully recurrent => O(1) decode state, runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
)

SMOKE_CONFIG = reduced(CONFIG, num_heads=2, num_kv_heads=2, head_dim=32,
                       d_model=64, d_ff=0)
