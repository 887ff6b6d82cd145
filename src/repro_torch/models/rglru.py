"""RecurrentGemma's recurrent block: causal conv + RG-LRU (arXiv:2402.19427).

The port of ``repro/models/rglru.py``. The RG-LRU is an element-wise
gated linear recurrence

    r_t = sigmoid(W_a x_t)                (recurrence gate)
    i_t = sigmoid(W_x x_t)                (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

and the block is

    x ──ln──┬── proj_gate ── gelu ──────────────┐
            └── proj_rec ── conv1d ── RG-LRU ──⊙── proj_out ── (+residual)

Prefill (S > 1) runs the recurrence through the RG-LRU scan kernel
(:func:`repro_torch.kernels.rglru.ops.rglru_scan`), where ``repro``'s
model calls ``jax.lax.associative_scan``; decode takes one sequential
step and reaches no kernel. The gate products ``xf @ w_a`` and ``xf @
w_x`` are float32 (the card runs them without TF32). Under sharding
rules the scan takes each rank's own batch rows (``sharding.local_call``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_call, lshard
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.models.layers import Params, dense_spec, mm

__all__ = ["rglru_params", "rglru_gates", "rglru_forward",
           "rglru_state_init"]

_C = 8.0  # recurrence sharpness constant from the paper


def rglru_params(cfg: ModelConfig) -> dict[str, tuple]:
    d = w = cfg.d_model         # lru width = d_model
    dt = getattr(torch, cfg.param_dtype)
    return {
        "proj_gate": dense_spec((d, w), dt),
        "proj_rec": dense_spec((d, w), dt),
        "proj_out": dense_spec((w, d), dt),
        "conv_w": dense_spec((cfg.conv_kernel, w), dt, scale=0.1),
        "w_a": dense_spec((w, w), torch.float32, scale=0.01),
        "w_x": dense_spec((w, w), torch.float32, scale=0.01),
        # Λ so that a ∈ (0.9, 0.999) at r=1 (the paper's init range)
        "lam": ((w,), torch.float32, ("linspace", 2.0, 6.0)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, w), w: (k, w); ``state`` the last
    k-1 inputs before x. Returns (out in x's dtype, the new tail)."""
    k = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, k - 1, 0))
    else:
        dt = torch.promote_types(state.dtype, x.dtype)
        x_pad = torch.cat([state.to(dt), x.to(dt)], dim=1)
    out = sum(x_pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    tail = x_pad[:, -(k - 1):, :] if k > 1 else None
    return out.to(x.dtype), tail


def rglru_gates(p: Params, xr: torch.Tensor):
    """(a, b) of the recurrence, in float32."""
    xf = xr.float()
    r = torch.sigmoid(xf @ p["w_a"])
    i = torch.sigmoid(xf @ p["w_x"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * xf)
    return a, b


def rglru_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: dict | None = None):
    """x: (B, S, d). ``state``: {"conv": (B, k-1, w), "h": (B, w)} in
    decode, else None. Returns (out, new state or None)."""
    gate = F.gelu(mm(x, p["proj_gate"]), approximate="tanh")
    xr = mm(x, p["proj_rec"])
    xr, conv_tail = _causal_conv(xr, p["conv_w"],
                                 state["conv"] if state is not None else None)
    xr = lshard(xr, "batch", "seq", "ff")
    a, b = rglru_gates(p, xr)
    if x.shape[1] == 1 and state is not None:
        h = (a[:, 0] * state["h"] + b[:, 0])[:, None, :]  # one step, no scan
    else:
        h = (rglru_scan(a.contiguous(), b.contiguous(), state["h"])
             if state is not None else
             local_call(rglru_scan, a.contiguous(), b.contiguous(), lead=1))
    out = lshard(mm((gate.float() * h).to(x.dtype), p["proj_out"]),
                 "batch", "seq", "embed")
    new_state = None
    if state is not None:
        new_state = {"conv": conv_tail, "h": h[:, -1, :]}
    return out, new_state


def rglru_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    w = cfg.d_model
    return {"conv": torch.zeros(batch, cfg.conv_kernel - 1, w,
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros(batch, w, dtype=torch.float32, device=device)}
