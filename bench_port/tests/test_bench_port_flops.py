"""Each configuration's frozen operation count against a count by hand
at one small shape: one layer, d 4, 2 heads over 1 kv head of dim 2,
ff 3, 4 experts top-2 (the MoE), a 256-row vocabulary; a prefill of
one sequence of 2 tokens, a decode step over 3 valid positions."""
from pathlib import Path

import pytest

from bench_port.harness import load_file

HERE = Path(__file__).resolve().parents[1]
SHAPE = dict(num_layers=1, d_model=4, num_heads=2, num_kv_heads=1,
             head_dim=2, d_ff=3, vocab_size=250)
# per token: q 2*4*4 = 32, k and v 2*2*4*2 = 32, out 2*4*4 = 32; a dense
# SwiGLU 3*2*4*3 = 72; the MoE's router 2*4*4 = 32 and two experts 144.
# Attention: 4*hd*H = 16 a live pair, 3 causal pairs in 2 tokens (48),
# 3 valid positions in decode (48). Logits: 2*4*256 = 2048 a sequence.
HAND = {"granite-moe-3b": {"prefill": {"total": 2 * 272 + 48 + 2048,
                                       "flash": 48},
                           "decode": {"total": 272 + 48 + 2048}},
        "phi4-mini-3b": {"prefill": {"total": 2 * 168 + 48 + 2048,
                                     "flash": 48},
                         "decode": {"total": 168 + 48 + 2048}}}


@pytest.mark.parametrize("name", sorted(HAND))
def test_frozen_counts_match_the_hand_count(name):
    flops = load_file(HERE / "flops" / f"{name}.py")
    m = dict(SHAPE)
    if name.startswith("granite"):
        m["moe"] = {"num_experts": 4, "experts_per_token": 2}
    assert flops.prefill(m, 1, 2) == HAND[name]["prefill"]
    assert flops.decode(m, 1, 3) == HAND[name]["decode"]
    # linear in the batch
    assert flops.decode(m, 5, 3)["total"] == 5 * HAND[name]["decode"]["total"]
