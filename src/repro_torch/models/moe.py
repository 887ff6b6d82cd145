"""Mixture-of-Experts layer: GShard-style grouped top-k routing.

The port of ``repro/models/moe.py``, with its semantics kept exactly:

- Tokens are routed in fixed-size *groups*: ``g`` is the largest divisor
  of S not above ``cfg.moe.group_size``. Each expert takes at most
  ``c = _capacity(cfg)`` (token, slot) pairs of a group, in token order
  then slot order; the rest are dropped and the surviving gates of a
  token renormalized. ``c`` is computed from ``group_size``, not from
  ``g``: a one-token decode step gets the same ``c`` and drops nothing.
- The router runs in float32; its top-k breaks ties toward the lower
  expert index, as ``jax.lax.top_k`` does (a stable sort, not
  ``torch.topk``, which promises no order among equal values).
- Dispatch gathers each kept pair's token into its (expert, slot); the
  gathered tokens are rounded to bfloat16 whatever the config's dtype,
  as in ``repro``, and the expert products promote them against the
  weights. The combine gathers each pair's expert output back in
  float32 and gate-sums it; the output is cast to the input's dtype.
- The load-balancing aux loss (Shazeer et al.) counts the top-k choices
  before the drop; each sequence chunk of groups gives one, and the
  layer returns their mean.

``repro`` scans the sequence chunks one by one; groups are independent,
so the port routes all ``n * B`` groups of a call at once (the same
numbers, fewer launches). The token index of each kept (expert, slot)
is written with a plain indexed store over unique indices (the dropped
pairs are filtered out first): no ``index_add_``/``scatter_add_``,
whose float atomics would make the result vary from run to run.

The expert products are plain batched matrix products over the stacked
(E, d, f) weights (``torch.bmm``): ``repro`` leaves them to XLA outside
any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = ["MoE", "moe_params", "group_size", "route", "moe_forward"]


def moe_params(cfg: ModelConfig) -> tuple[dict, dict]:
    """The specs of the float32 router (d, E) and of the stacked expert
    weights, (E, d, f) and (E, f, d) at ``repro``'s scales."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
    dt = getattr(torch, cfg.param_dtype)
    up = L.dense_spec((E, d, f), dt, scale=1 / math.sqrt(d))
    down = L.dense_spec((E, f, d), dt, scale=1 / math.sqrt(f))
    experts = ({"w_gate": up, "w_up": up, "w_down": down}
               if cfg.act == "swiglu" else {"w_up": up, "w_down": down})
    return {"router": L.dense_spec((d, E), torch.float32, scale=0.02)}, experts


class MoE(L.ParamModule):
    """``router`` (d, E) float32; ``experts``: ``w_gate``/``w_up`` (E, d,
    f) and ``w_down`` (E, f, d); ``shared``, an MLP, when the config has a
    shared expert. Names as in ``repro``'s ``ffn`` tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        router, experts = moe_params(cfg)
        super().__init__(router, device)
        self.experts = L.ParamModule(experts, device)
        if cfg.moe.shared_expert:
            self.shared = L.ParamModule(L.mlp_params(cfg), device)


def _capacity(cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(m.group_size * m.experts_per_token / m.num_experts
                      * m.capacity_factor))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def group_size(cfg: ModelConfig, S: int) -> int:
    """The largest divisor of S not above ``cfg.moe.group_size``."""
    g = min(cfg.moe.group_size, S)
    while S % g:
        g -= 1
    return g


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, T, a) @ (E, a, b) in the promoted dtype, as JAX's einsum."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.bmm(x, w)


def route(p, xg: torch.Tensor, cfg: ModelConfig):
    """The routing decisions of groups ``xg`` (N, g, d): ``probs`` (N, g,
    E) float32, ``expert_idx`` (N, g, k), ``pos`` (N, g, k) each pair's
    place in its expert's queue, ``keep`` (N, g, k) ``pos < c``, and the
    renormalized ``gates`` (N, g, k) float32 (0 where dropped)."""
    m = cfg.moe
    E, k, c = m.num_experts, m.experts_per_token, _capacity(cfg)
    N, g, _ = xg.shape
    probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    # top-k with ties toward the lower expert index, as jax.lax.top_k
    gates, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gates, expert_idx = gates[..., :k], expert_idx[..., :k]
    onehot = F.one_hot(expert_idx, E).to(torch.int32)          # (N, g, k, E)
    flat = onehot.reshape(N, g * k, E)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(N, g, k)
    keep = pos < c
    gates = gates * keep
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, expert_idx, pos, keep, gates


def _route_groups(p, xg: torch.Tensor, cfg: ModelConfig, n: int):
    """Route the groups ``xg`` (N = n * B, g, d), chunk-major; returns
    (out (N, g, d) in xg's dtype, aux of each of the n chunks (n,))."""
    m = cfg.moe
    E, k, c = m.num_experts, m.experts_per_token, _capacity(cfg)
    N, g, d = xg.shape
    probs, expert_idx, pos, keep, gates = route(p, xg, cfg)
    dev = xg.device
    # dispatch: the token index of each kept (expert, slot); g, the index
    # of an appended zero row, marks an empty slot
    src = torch.full((N, E * c), g, dtype=torch.long, device=dev)
    rows = torch.arange(N, device=dev)[:, None, None].expand(N, g, k)
    toks = torch.arange(g, device=dev)[None, :, None].expand(N, g, k)
    src[rows[keep], (expert_idx * c + pos)[keep]] = toks[keep]
    xpad = torch.cat([xg.to(torch.bfloat16),
                      xg.new_zeros((N, 1, d), dtype=torch.bfloat16)], dim=1)
    xin = xpad[torch.arange(N, device=dev)[:, None], src]      # (N, E*c, d)
    # the experts, batched over E: (E, N*c, d)
    xe = xin.reshape(N, E, c, d).transpose(0, 1).reshape(E, N * c, d)
    ew = p["experts"]
    if "w_gate" in ew:
        h = F.silu(_bmm(xe, ew["w_gate"])) * _bmm(xe, ew["w_up"])
    else:                           # jax.nn.gelu is the tanh approximation
        h = F.gelu(_bmm(xe, ew["w_up"]), approximate="tanh")
    eout = _bmm(h, ew["w_down"]).reshape(E, N, c, d).transpose(0, 1)
    eflat = eout.reshape(N, E * c, d).float()
    # combine: each pair's expert output, gate-summed in float32
    slot = torch.where(keep, pos, c).clamp_max(c - 1)
    picked = eflat[torch.arange(N, device=dev)[:, None],
                   (expert_idx * c + slot).reshape(N, g * k)]
    picked = picked.reshape(N, g, k, d) * keep[..., None]
    out = torch.einsum("ngkd,ngk->ngd", picked, gates)
    # load-balance aux per chunk: E * sum_e f_e * P_e / k, f_e before drop
    counts = F.one_hot(expert_idx, E).sum(2).float()           # (N, g, E)
    f_e = counts.reshape(n, -1, E).mean(1)
    P_e = probs.reshape(n, -1, E).mean(1)
    aux = E * (f_e * P_e).sum(-1) / k
    return out.to(xg.dtype), aux


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), aux loss, a float32 scalar).
    Groups are contiguous token chunks of each sequence."""
    B, S, d = x.shape
    g = group_size(cfg, S)
    n = S // g
    xg = x.reshape(B, n, g, d).transpose(0, 1).reshape(n * B, g, d)
    out, aux = _route_groups(p, xg, cfg, n)
    out = out.reshape(n, B, g, d).transpose(0, 1).reshape(B, S, d)
    if "shared" in p:
        out = out + L.mlp_forward(p["shared"], x, cfg)
    return out, aux.mean()
