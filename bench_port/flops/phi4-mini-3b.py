"""Frozen operation counts of phi4-mini-3b's serving steps
(``bench_port/flopcount.py``). Per token and layer: the q, k, v and
output projections and the SwiGLU MLP's three products."""
from bench_port.flopcount import decoder


def token_layer(m):
    d, f, hd = m["d_model"], m["d_ff"], m["head_dim"]
    H, K = m["num_heads"], m["num_kv_heads"]
    return 2 * d * H * hd + 2 * 2 * d * K * hd + 2 * H * hd * d + 3 * 2 * d * f


prefill, decode = decoder(token_layer)
