"""The plain reference of DeepSeek-V2 (``bench_port/configs/
deepseek-v2-lite.json``), and its control.

A straightforward float32 forward pass in plain PyTorch of the
configuration as it is run (its ``model`` object), after the published
``modeling_deepseek.py``: token embedding; per layer RMSNorm, multi-head
latent attention, residual; RMSNorm, an FFN, residual; a final RMSNorm
and an untied head. Latent attention, per token and head, with ``x`` the
normed input:

- ``q = x Wq`` split into ``q_nope`` and ``q_pe``; ``[c, k_pe] = x
  Wkv_a``, ``c`` RMS-normed (``kv_norm``); ``[k_nope, v] = c Wkv_b``;
- YaRN RoPE on ``q_pe`` and on ``k_pe`` (one key shared by all heads):
  the rope dims de-interleaved, then the halves rotated at frequencies
  ``f_extra (1 - m) / factor + f_extra m`` with ``f_extra = theta^(-2i /
  rope)`` and ``m`` a ramp from 1 to 0 between the correction dims that
  ``beta_fast`` and ``beta_slow`` rotations over the original context
  give; cos and sin times ``yarn_mscale(mscale) /
  yarn_mscale(mscale_all_dim)``;
- causal softmax attention over ``k = [k_nope, k_pe]`` with the scale
  ``qk_head_dim^-1/2 yarn_mscale(mscale_all_dim)^2``, in query blocks;
  the heads' outputs times ``Wo``.

The first ``first_dense_layers`` layers take a SwiGLU MLP of
``dense_d_ff``; the others a mixture of experts whose routing is the
decoder reference's (``decoder.py``: the port's GShard groups and
capacity, a departure from the published dropless layer that the
configuration file states; the prefill judge follows the program's
recorded choice), with the gates left as the router's probabilities
where ``norm_topk_prob`` is False, plus a shared SwiGLU MLP of
``shared_d_ff`` over every token.

It imports nothing of the program; it takes the decoder reference's
helpers (norms, MLP, float8 control, logits). ``hidden``'s ``kv`` is
what a latent layer hands to its cache: the normed latent ``c`` (B, 1,
positions, r) and the RoPE'd ``k_pe`` (B, 1, positions, rope).
``routed_layers`` names the layers past the dense ones.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench_port.reference import decoder as D
from bench_port.reference.decoder import Arith, capacity, group_size, logits

__all__ = ["Arith", "capacity", "group_size", "hidden", "logits",
           "routed_layers", "weight_specs"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def weight_specs(m: dict) -> dict:
    """name -> (shape, dtype, scale), in order, the program's names:
    bfloat16 matrices at ``1/sqrt(fan_in)``, 0.02 for the embedding, the
    head and the float32 router; float32 norm scales of ones."""
    d, f, V = m["d_model"], m["d_ff"], -(-m["vocab_size"] // 256) * 256
    a, moe, H = m["mla"], m["moe"], m["num_heads"]
    r, nope, rope, vd = (a["kv_lora_rank"], a["qk_nope_head_dim"],
                         a["qk_rope_head_dim"], a["v_head_dim"])
    bf, f32 = getattr(torch, m["param_dtype"]), torch.float32

    def mlp(pre, width):
        return {pre + "w_gate": ((d, width), bf, 1 / math.sqrt(d)),
                pre + "w_up": ((d, width), bf, 1 / math.sqrt(d)),
                pre + "w_down": ((width, d), bf, 1 / math.sqrt(width))}

    specs = {"embed": ((V, d), bf, 0.02), "lm_head": ((d, V), bf, 0.02),
             "final_norm.scale": ((d,), f32, None)}
    for i in range(m["num_layers"]):
        p = f"layers.{i}."
        specs.update({
            p + "norm1.scale": ((d,), f32, None),
            p + "mix.wq": ((d, H * (nope + rope)), bf, 1 / math.sqrt(d)),
            p + "mix.wkv_a": ((d, r + rope), bf, 1 / math.sqrt(d)),
            p + "mix.kv_norm.scale": ((r,), f32, None),
            p + "mix.wkv_b": ((r, H * (nope + vd)), bf, 1 / math.sqrt(r)),
            p + "mix.wo": ((H * vd, d), bf, 1 / math.sqrt(H * vd)),
            p + "norm2.scale": ((d,), f32, None)})
        if i < m["first_dense_layers"]:
            specs.update(mlp(p + "ffn.", m["dense_d_ff"]))
            continue
        E = moe["num_experts"]
        specs.update({
            p + "ffn.router": ((d, E), f32, 0.02),
            p + "ffn.experts.w_gate": ((E, d, f), bf, 1 / math.sqrt(d)),
            p + "ffn.experts.w_up": ((E, d, f), bf, 1 / math.sqrt(d)),
            p + "ffn.experts.w_down": ((E, f, d), bf, 1 / math.sqrt(f))})
        specs.update(mlp(p + "ffn.shared.", m["shared_d_ff"]))
    return specs


def routed_layers(m: dict) -> list:
    return list(range(m["first_dense_layers"], m["num_layers"]))


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def inv_freq(m: dict, device=None) -> torch.Tensor:
    """YaRN's frequencies of the rope dims, float64."""
    a, base = m["mla"], m["rope_theta"]
    dim, factor = a["qk_rope_head_dim"], a["rope_factor"]
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                        device=device) / dim)
    if factor <= 1:
        return extra

    def corr(rotations):
        return (dim * math.log(a["rope_original_max_position"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    lo = max(math.floor(corr(a["rope_beta_fast"])), 0)
    hi = min(math.ceil(corr(a["rope_beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    mask = 1 - ramp
    return extra / factor * (1 - mask) + extra * mask


def softmax_scale(m: dict) -> float:
    a = m["mla"]
    scale = (a["qk_nope_head_dim"] + a["qk_rope_head_dim"]) ** -0.5
    if a["rope_mscale_all_dim"]:
        scale *= _mscale(a["rope_factor"], a["rope_mscale_all_dim"]) ** 2
    return scale


def _rope(x, m):
    """x (B, S, heads, rope) at positions 0..S-1: de-interleaved, then
    the halves rotated."""
    a = m["mla"]
    B, S, heads, dim = x.shape
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv_freq(m, x.device)).float()
    mul = 1.0
    if a["rope_mscale_all_dim"]:
        mul = (_mscale(a["rope_factor"], a["rope_mscale"])
               / _mscale(a["rope_factor"], a["rope_mscale_all_dim"]))
    cos, sin = ang.cos()[:, None] * mul, ang.sin()[:, None] * mul
    x = x.view(B, S, heads, dim // 2, 2).transpose(-1, -2).reshape(
        B, S, heads, dim)
    x1, x2 = x[..., :dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, scale, ar: Arith, block: int = 512):
    """Causal softmax attention, q and k (B, H, S, qk), v (B, H, S, v),
    in query blocks: a block's queries see every earlier block whole and
    the lower triangle of their own (q is scaled before the product)."""
    S = q.shape[2]
    q = q * scale
    out = q.new_empty((*q.shape[:3], v.shape[-1]))
    ahead = torch.ones(block, block, dtype=torch.bool,
                       device=q.device).triu(1)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = ar.mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2))
        s[..., lo:].masked_fill_(ahead[:hi - lo, :hi - lo], float("-inf"))
        out[:, :, lo:hi] = ar.mm(torch.softmax(s, -1), v[:, :, :hi])
    return out


def _mla(m, h, W, pre, ar, kv_at, stats):
    a = m["mla"]
    B, S, _ = h.shape
    H, r = m["num_heads"], a["kv_lora_rank"]
    nope, vd = a["qk_nope_head_dim"], a["v_head_dim"]
    q = ar.mm(h, W[pre + "wq"]).view(B, S, H, -1)
    kv_a = ar.mm(h, W[pre + "wkv_a"])
    c = D._rmsnorm(kv_a[..., :r], W[pre + "kv_norm.scale"], m["norm_eps"])
    k_pe = _rope(kv_a[..., None, r:], m)                     # (B, S, 1, rope)
    kv = ar.mm(c, W[pre + "wkv_b"]).view(B, S, H, nope + vd)
    if kv_at is not None:
        stats.setdefault("kv", []).append(
            (c[:, kv_at][:, None], k_pe[:, kv_at].transpose(1, 2)))
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], m)], -1)
    k = torch.cat([kv[..., :nope], k_pe.expand(B, S, H, -1)], -1)
    o = _attention(q.transpose(1, 2).contiguous(),
                   k.transpose(1, 2).contiguous(),
                   kv[..., nope:].transpose(1, 2).contiguous(),
                   softmax_scale(m), ar)
    return ar.mm(o.transpose(1, 2).reshape(B, S, H * vd), W[pre + "wo"])


def _moe(m, h, W, pre, ar, follow, stats):
    """The decoder reference's mixture of experts (routing, capacity and
    the expert products as there), the gates renormalized only where
    ``norm_topk_prob`` says so, plus the shared MLP."""
    moe = m["moe"]
    E, k, c = moe["num_experts"], moe["experts_per_token"], capacity(m)
    B, S, d = h.shape
    g = group_size(m, S)
    n = S // g
    logit = (h @ W[pre + "router"].float()).view(B, n, g, E)
    probs = torch.softmax(logit, -1)
    order = torch.sort(logit, dim=-1, descending=True, stable=True).indices
    chosen = order[..., :k] if follow is None else follow.to(h.device)
    if follow is not None:
        kth = logit.gather(-1, order[..., k - 1:k])[..., 0]
        low = logit.gather(-1, chosen).amin(-1)
        stats["route_shortfall"] = max(stats.get("route_shortfall", 0.0),
                                       float((kth - low).clamp_min(0).max()))
    stats.setdefault("routing", []).append(chosen)
    onehot = F.one_hot(chosen, E).view(B, n, g * k, E)
    pos = ((onehot.cumsum(2) - onehot) * onehot).sum(-1).view(B, n, g, k)
    keep = pos < c
    gates = probs.gather(-1, chosen) * keep
    if m["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    token = torch.arange(B * S, device=h.device).view(B, n, g, 1) \
        .expand(B, n, g, k)
    flat = h.reshape(B * S, d)
    out = torch.zeros_like(flat)
    for e in range(E):
        sel = (chosen == e) & keep
        tok, gate = token[sel], gates[sel]
        if tok.numel() == 0:
            continue
        x = flat[tok]
        y = ar.mm(F.silu(ar.mm(x, W[pre + "experts.w_gate"][e]))
                  * ar.mm(x, W[pre + "experts.w_up"][e]),
                  W[pre + "experts.w_down"][e])
        out.index_add_(0, tok, y * gate[:, None])
    return out.view(B, S, d) + D._mlp(h, W, pre + "shared.", ar)


def hidden(m: dict, W: dict, tokens: torch.Tensor, ar: Arith | None = None,
           follow: list | None = None, kv_at: torch.Tensor | None = None):
    """The final-normed hidden states (B, S, d) float32 of ``tokens``
    (B, S), and ``stats``: ``routing``, each routed layer's choice (B,
    n, g, k); with ``follow`` (one choice per routed layer) the
    ``route_shortfall``; with ``kv_at`` (positions) ``kv``, each layer's
    (c, k_pe) there."""
    ar = ar or Arith()
    eps = m["norm_eps"]
    stats: dict = {}
    x = ar.rows(W["embed"][tokens])
    for i in range(m["num_layers"]):
        pre = f"layers.{i}."
        h = D._rmsnorm(x, W[pre + "norm1.scale"], eps)
        x = x + _mla(m, h, W, pre + "mix.", ar, kv_at, stats)
        h = D._rmsnorm(x, W[pre + "norm2.scale"], eps)
        if i < m["first_dense_layers"]:
            x = x + D._mlp(h, W, pre + "ffn.", ar)
        else:
            layer_follow = None if follow is None else follow[
                len(stats.get("routing", []))]
            x = x + _moe(m, h, W, pre + "ffn.", ar, layer_follow, stats)
    return D._rmsnorm(x, W["final_norm.scale"], eps), stats
