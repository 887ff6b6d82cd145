"""The benchmark's weights and token streams, made from ``--seed``.

Both the program and the reference are handed what this module makes:
the program through ``load_state_dict(..., assign=True)`` into a model
built on ``meta``, the reference by calling it again after the window.
The weights are drawn on the device in the type they are served in
(bfloat16 matrices; float32 norm scales and router), every matrix of a
dtype as a view of one buffer filled by a single ``randn`` call and then
scaled in place (``1/sqrt(fan_in)``; 0.02 for the embedding, the head
and the router; ones for the norm scales). The names and shapes are the
program's parameter names. The same seed on the same device gives the
same bits.
"""
from __future__ import annotations

import hashlib
import math

import torch

__all__ = ["derive", "generator", "make_weights", "weight_specs"]


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream (weights, a batch, the prompts),
    from the run's seed and the stream's tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def weight_specs(m: dict) -> dict:
    """name -> (shape, dtype, scale); scale None for ones."""
    d, f, V = m["d_model"], m["d_ff"], -(-m["vocab_size"] // 256) * 256
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    bf, f32 = getattr(torch, m["param_dtype"]), torch.float32
    specs = {"embed": ((V, d), bf, 0.02)}
    if not m["tie_embeddings"]:
        specs["lm_head"] = ((d, V), bf, 0.02)
    specs["final_norm.scale"] = ((d,), f32, None)
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        specs.update({
            p + "norm1.scale": ((d,), f32, None),
            p + "mix.wq": ((d, H * hd), bf, 1 / math.sqrt(d)),
            p + "mix.wk": ((d, K * hd), bf, 1 / math.sqrt(d)),
            p + "mix.wv": ((d, K * hd), bf, 1 / math.sqrt(d)),
            p + "mix.wo": ((H * hd, d), bf, 1 / math.sqrt(H * hd)),
            p + "norm2.scale": ((d,), f32, None)})
        moe = m.get("moe")
        if moe:
            E = moe["num_experts"]
            specs.update({
                p + "ffn.router": ((d, E), f32, 0.02),
                p + "ffn.experts.w_gate": ((E, d, f), bf, 1 / math.sqrt(d)),
                p + "ffn.experts.w_up": ((E, d, f), bf, 1 / math.sqrt(d)),
                p + "ffn.experts.w_down": ((E, f, d), bf, 1 / math.sqrt(f))})
        else:
            specs.update({
                p + "ffn.w_gate": ((d, f), bf, 1 / math.sqrt(d)),
                p + "ffn.w_up": ((d, f), bf, 1 / math.sqrt(d)),
                p + "ffn.w_down": ((f, d), bf, 1 / math.sqrt(f))})
    return specs


@torch.no_grad()
def make_weights(m: dict, seed: int, device) -> dict:
    """The state dict of the configuration ``m`` (its ``model`` object)
    for ``seed``, on ``device``."""
    specs = weight_specs(m)
    out = {}
    for dtype in sorted({s[1] for s in specs.values()}, key=str):
        drawn = [(n, s) for n, s in specs.items()
                 if s[1] == dtype and s[2] is not None]
        ones = [(n, s) for n, s in specs.items()
                if s[1] == dtype and s[2] is None]
        total = sum(math.prod(s[0]) for _, s in drawn)
        buf = torch.randn(total, generator=generator(device, seed, "weights",
                                                     dtype),
                          dtype=dtype, device=device)
        at = 0
        for name, (shape, _, scale) in drawn:
            size = math.prod(shape)
            out[name] = buf[at:at + size].view(shape).mul_(scale)
            at += size
        for name, (shape, _, _) in ones:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return out
