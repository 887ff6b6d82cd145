"""The plain reference of the decoder the benchmark serves, and its control.

A straightforward float32 forward pass in plain PyTorch of the
configuration as it is run (``bench_port/configs/<name>.json``, its
``model`` object): token embedding; per layer RMSNorm, grouped-query
attention with RoPE on the two halves of the head dim and a causal
softmax, residual; RMSNorm, a SwiGLU MLP or a mixture of experts,
residual; a final RMSNorm and the logits. It imports nothing of the
program and uses none of its kernels, oracles or helpers; it is handed
the benchmark's own weights (``bench_port/weights.py``, drawn from the
parameter list ``weight_specs`` declares here), the same as the program,
and works everything else out again. ``routed_layers`` names the layers
whose routing the prefill judge follows.

The mixture of experts keeps the configuration's routing rule, which
departs from the published dropless layer (see the configuration file):
tokens are routed in groups of ``g`` (the largest divisor of the
sequence length not above ``group_size``), each token to its top ``k``
experts by a float32 softmax router, ties toward the lower index; an
expert takes at most ``c`` (token, slot) pairs of a group, in token then
slot order, and the gates that survive are renormalized.

Routing is a discontinuous function of the hidden state: a rounding in
the program can swap a token's k-th and (k+1)-th experts, and a capacity
drop then moves for every later token of the group. So the judge does
not re-route: it hands the program's recorded choice in as ``follow``,
measures how far below its own k-th router logit each followed choice
lies (``route_shortfall``, a number it compares), and computes the rest
of the layer from that choice in float32.

``Arith(fp8=True)`` is the control: every matrix product of the
reference (the router's excepted, which the configuration states in
float32) takes its operands rounded to float8 e4m3, each row of the left
and each column of the right operand scaled to the format's largest
value, and accumulates in float32; embedding rows are rounded the same
way. Norms, RoPE and softmax stay float32, as in the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Arith", "capacity", "group_size", "hidden", "logits",
           "routed_layers", "weight_specs"]

FP8_MAX = 448.0


def capacity(m: dict) -> int:
    """Pairs an expert takes from one group: from ``group_size``, a
    multiple of 4 and at least 4."""
    moe = m["moe"]
    c = math.ceil(moe["group_size"] * moe["experts_per_token"]
                  / moe["num_experts"] * moe["capacity_factor"])
    return max(4, -(-c // 4) * 4)


def group_size(m: dict, S: int) -> int:
    g = min(m["moe"]["group_size"], S)
    while S % g:
        g -= 1
    return g


def weight_specs(m: dict) -> dict:
    """The parameter list the benchmark draws (``bench_port/weights.py``):
    name -> (shape, dtype, scale), scale None for ones. The program's
    parameter names and shapes; bfloat16 matrices at ``1/sqrt(fan_in)``,
    0.02 for the embedding, the head and the float32 router; float32
    norm scales of ones."""
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


def routed_layers(m: dict) -> list:
    """The layers that route to experts, in order: every layer of a
    mixture of experts, none of a dense model."""
    return list(range(m["num_layers"])) if m.get("moe") else []


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """Matrix products in float32, or with float8 operands (the
    control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., M, K) @ b (..., K, N)."""
        a, b = a.float(), b.float()
        if self.fp8:
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x.float(), -1) if self.fp8 else x.float()


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x, theta):
    """x (B, S, heads, hd), positions 0..S-1."""
    S, half = x.shape[1], x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, ar: Arith, block: int = 512):
    """Causal softmax attention, q (B, H, S, hd), k and v (B, K, S, hd),
    query head h reading kv head h // (H / K); in query blocks."""
    B, H, S, hd = q.shape
    k = k.repeat_interleave(H // k.shape[1], 1)
    v = v.repeat_interleave(H // v.shape[1], 1)
    out = torch.empty_like(q)
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = ar.mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2)) \
            / math.sqrt(hd)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        p = torch.softmax(s.masked_fill(kpos > qpos, float("-inf")), -1)
        out[:, :, lo:hi] = ar.mm(p, v[:, :, :hi])
    return out


def _mlp(h, W, pre, ar):
    return ar.mm(F.silu(ar.mm(h, W[pre + "w_gate"]))
                 * ar.mm(h, W[pre + "w_up"]), W[pre + "w_down"])


def _moe(m, h, W, pre, ar, follow, stats):
    """h (B, S, d) float32. ``follow`` (B, n, g, k): the choice to
    follow, or None to route by this arithmetic's own router."""
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
    return out.view(B, S, d)


def hidden(m: dict, W: dict, tokens: torch.Tensor, ar: Arith | None = None,
           follow: list | None = None, kv_at: torch.Tensor | None = None):
    """The final-normed hidden states (B, S, d) float32 of ``tokens``
    (B, S), and ``stats``: ``routing``, each MoE layer's choice (B, n,
    g, k); with ``follow`` (one choice per MoE layer) the
    ``route_shortfall``; with ``kv_at`` (positions) ``kv``, each
    layer's keys (after RoPE) and values there, (B, K, positions, hd)
    each, as a prefill hands them to a cache."""
    ar = ar or Arith()
    B, S = tokens.shape
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    stats: dict = {}
    x = ar.rows(W["embed"][tokens])
    for i in range(m["num_layers"]):
        pre = f"layers.{i}."
        h = _rmsnorm(x, W[pre + "norm1.scale"], eps)
        q = _rope(ar.mm(h, W[pre + "mix.wq"]).view(B, S, H, hd), theta)
        kk = _rope(ar.mm(h, W[pre + "mix.wk"]).view(B, S, K, hd), theta)
        v = ar.mm(h, W[pre + "mix.wv"]).view(B, S, K, hd)
        if kv_at is not None:
            stats.setdefault("kv", []).append(
                (kk[:, kv_at].transpose(1, 2), v[:, kv_at].transpose(1, 2)))
        o = _attention(q.transpose(1, 2), kk.transpose(1, 2),
                       v.transpose(1, 2), ar)
        x = x + ar.mm(o.transpose(1, 2).reshape(B, S, H * hd),
                      W[pre + "mix.wo"])
        h = _rmsnorm(x, W[pre + "norm2.scale"], eps)
        if m.get("moe"):
            layer_follow = None if follow is None else follow[
                len(stats.get("routing", []))]
            x = x + _moe(m, h, W, pre + "ffn.", ar, layer_follow, stats)
        else:
            x = x + _mlp(h, W, pre + "ffn.", ar)
    return _rmsnorm(x, W["final_norm.scale"], eps), stats


def logits(m: dict, W: dict, h: torch.Tensor,
           ar: Arith | None = None) -> torch.Tensor:
    """Logits over the real vocabulary, float32, of hidden rows h (...,
    d)."""
    ar = ar or Arith()
    V = m["vocab_size"]
    head = (W["embed"][:V].T if m["tie_embeddings"]
            else W["lm_head"][:, :V])
    return ar.mm(h, head)
