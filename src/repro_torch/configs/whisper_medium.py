"""whisper-medium [audio]: enc-dec, conv frontend STUBBED.

24L (encoder) + 24L (decoder), d_model=1024, 16H (kv=16), d_ff=4096,
vocab=51865 [arXiv:2212.04356]. The audio conv frontend is a stub:
``input_specs`` provides precomputed 1500-frame embeddings; the decoder
backbone handles the assigned LM shapes with cross-attention to them.
GELU MLP (whisper uses GELU, not SwiGLU); biases on attention.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=24,
    num_source_positions=1500,
    act="gelu",
    use_bias=True,
    tie_embeddings=True,
)

SMOKE_CONFIG = reduced(CONFIG)
