"""Frozen operation counts of granite-moe-3b's serving steps
(``bench_port/flopcount.py``). Per token and layer: the q, k, v and
output projections, the router, and the token's ``experts_per_token``
expert SwiGLU MLPs (three products each; capacity drops and empty slots
are not counted)."""
from bench_port.flopcount import decoder


def token_layer(m):
    d, f, hd = m["d_model"], m["d_ff"], m["head_dim"]
    H, K = m["num_heads"], m["num_kv_heads"]
    E, k = m["moe"]["num_experts"], m["moe"]["experts_per_token"]
    return (2 * d * H * hd + 2 * 2 * d * K * hd + 2 * H * hd * d
            + 2 * d * E + k * 3 * 2 * d * f)


prefill, decode = decoder(token_layer)
