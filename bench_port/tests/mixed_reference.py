"""The plain reference of a test-only configuration whose layers differ
(``bench_port/tests/mixed.json``), brought as data: the harness takes it
through the same entry points as ``bench_port/reference/decoder.py``.

Its blocks cycle over ``block_pattern``: a ``local`` block attends to
the ``local_window`` latest positions, its own among them, an ``attn``
block to every earlier one. Its mixture of experts adds a shared expert,
a SwiGLU MLP over every token (``ffn.shared.*``), to what the routed
experts return. The rest is the decoder's, whose pieces it reuses; like
the decoder it imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from bench_port.reference import decoder as D
from bench_port.reference.decoder import Arith, capacity, group_size, logits

__all__ = ["Arith", "capacity", "group_size", "hidden", "logits",
           "routed_layers", "weight_specs"]


def weight_specs(m: dict) -> dict:
    """The decoder's list, with each MoE layer's shared expert after its
    routed experts."""
    d, f = m["d_model"], m["d_ff"]
    bf = getattr(torch, m["param_dtype"])
    specs = {}
    for name, spec in D.weight_specs(m).items():
        specs[name] = spec
        if name.endswith("ffn.experts.w_down") and m["moe"]["shared_expert"]:
            pre = name[:-len("experts.w_down")] + "shared."
            specs.update({pre + "w_gate": ((d, f), bf, 1 / math.sqrt(d)),
                          pre + "w_up": ((d, f), bf, 1 / math.sqrt(d)),
                          pre + "w_down": ((f, d), bf, 1 / math.sqrt(f))})
    return specs


def routed_layers(m: dict) -> list:
    return list(range(m["num_layers"]))


def _attention(q, k, v, ar: Arith, window: int | None):
    """Causal softmax attention over (B, heads, S, hd), kv heads shared
    by H / K query heads; with ``window``, to the latest ``window``
    positions alone."""
    H, S, hd = q.shape[1], q.shape[2], q.shape[3]
    k = k.repeat_interleave(H // k.shape[1], 1)
    v = v.repeat_interleave(H // v.shape[1], 1)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    hidden_from = kpos > qpos
    if window is not None:
        hidden_from |= qpos - kpos >= window
    s = ar.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    return ar.mm(torch.softmax(s.masked_fill(hidden_from, float("-inf")),
                               -1), v)


def hidden(m: dict, W: dict, tokens: torch.Tensor, ar: Arith | None = None,
           follow: list | None = None, kv_at: torch.Tensor | None = None):
    """As the decoder's ``hidden``: the final-normed hidden states and
    ``stats`` (``routing``, ``route_shortfall`` with ``follow``, ``kv``
    with ``kv_at``: each layer's (k, v) there, local layers too)."""
    ar = ar or Arith()
    B, S = tokens.shape
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    pattern = m["block_pattern"]
    stats: dict = {}
    x = ar.rows(W["embed"][tokens])
    for i in range(m["num_layers"]):
        pre = f"layers.{i}."
        window = (m["local_window"] if pattern[i % len(pattern)] == "local"
                  else None)
        h = D._rmsnorm(x, W[pre + "norm1.scale"], eps)
        q = D._rope(ar.mm(h, W[pre + "mix.wq"]).view(B, S, H, hd), theta)
        kk = D._rope(ar.mm(h, W[pre + "mix.wk"]).view(B, S, K, hd), theta)
        v = ar.mm(h, W[pre + "mix.wv"]).view(B, S, K, hd)
        if kv_at is not None:
            stats.setdefault("kv", []).append(
                (kk[:, kv_at].transpose(1, 2), v[:, kv_at].transpose(1, 2)))
        o = _attention(q.transpose(1, 2), kk.transpose(1, 2),
                       v.transpose(1, 2), ar, window)
        x = x + ar.mm(o.transpose(1, 2).reshape(B, S, H * hd),
                      W[pre + "mix.wo"])
        h = D._rmsnorm(x, W[pre + "norm2.scale"], eps)
        layer_follow = None if follow is None else follow[
            len(stats.get("routing", []))]
        x = x + D._moe(m, h, W, pre + "ffn.", ar, layer_follow, stats)
        if m["moe"]["shared_expert"]:
            x = x + D._mlp(h, W, pre + "ffn.shared.", ar)
    return D._rmsnorm(x, W["final_norm.scale"], eps), stats
