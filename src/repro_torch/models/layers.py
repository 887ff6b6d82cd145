"""Transformer building blocks: norms, RoPE, GQA attention, MLPs.

The port of ``repro/models/layers.py``. The functions take their
parameters as ``p``, anything that maps ``repro``'s parameter names to
tensors: a plain dict (the tests hand ``repro``'s arrays over that way)
or one of the :class:`ParamModule`\\ s the model is built from.
Tensors are tagged with logical axes (:func:`~repro_torch.distributed.
sharding.lshard`) where ``repro``'s are: a no-op on plain tensors and
outside rules, a redistribution of a DTensor under them. The flash
kernel takes each rank's own heads (``sharding.local_call``).

Attention in prefill goes through the flash attention kernel
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`), where
``repro``'s model calls the XLA blockwise path (``flash_mha``); the two
compute the same function, and the tests hold the port's path against
``repro``'s. Decode is a one-token softmax over a ring-buffer KV cache
and reaches no kernel, as in ``repro``.

Dtypes follow ``repro``: activations in ``cfg.dtype``; a product of a
tensor with a parameter of another dtype is taken in the promoted dtype,
as JAX promotes; norms, RoPE and softmax in float32; logits from
bfloat16 operands come out in float32 (``preferred_element_type``),
computed here by upcasting before the product.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (gather_inner, gather_inner_grad,
                                              local_call, lshard, merge_last,
                                              split_last)
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["NEG_INF", "ParamModule", "mm", "rmsnorm", "rope",
           "full_attention", "attention_params", "attention_forward",
           "attention_decode", "attention_cache_init", "mlp_params",
           "mlp_forward"]

NEG_INF = -1e30
Params = Mapping[str, Any]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class ParamModule(nn.Module):
    """A module whose parameters carry ``repro``'s names.

    ``specs`` maps each name to ``(shape, dtype, init)``, where ``init``
    is the standard deviation of a normal draw, or ``"ones"``,
    ``"zeros"``, ``("linspace", lo, hi)`` or ``("halves", a, b)`` (the
    first half of a vector ``a``, the second ``b``), as ``repro``
    initializes that parameter. The tensors are allocated empty (on
    ``"meta"`` they take no memory) and filled by :meth:`init_params`.
    Parameters require gradients, as any module's: a serving caller
    runs the model under ``torch.no_grad()`` so that it builds no graph.
    ``p["name"]`` and ``"name" in p`` work as on ``repro``'s parameter
    dicts, for a parameter or a nested module (a subtree).
    """

    def __init__(self, specs: Mapping[str, tuple], device=None):
        super().__init__()
        self._inits = {}
        for name, (shape, dtype, init) in specs.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))
            self._inits[name] = init

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (on the parameters'
        device), with ``repro``'s scales."""
        for name, init in self._inits.items():
            p = self._parameters[name]
            if init == "ones":
                p.fill_(1)
            elif init == "zeros":
                p.zero_()
            elif isinstance(init, tuple) and init[0] == "halves":
                _, a, b = init
                half = p.shape[0] // 2
                p[:half].fill_(a)
                p[half:].fill_(b)
            elif isinstance(init, tuple):
                _, lo, hi = init
                p.copy_(torch.linspace(lo, hi, p.shape[0], device=p.device))
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device).mul_(init))


def dense_spec(shape, dtype, scale=None) -> tuple:
    """``repro``'s ``_dense_init``: normal with std ``1/sqrt(fan_in)``
    unless a scale is given."""
    return (shape, dtype, scale if scale is not None
            else 1.0 / math.sqrt(shape[0]))


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as JAX's ``@``.

    Under rules a DTensor ``x`` sharded on an inner dim (the sequence,
    under sequence parallelism) is gathered on it first, as Megatron's
    sequence parallelism gathers before a projection: the product folds
    (B, S) into one dim, and two sharded dims folded into one make a
    layout whose redistributions DTensor plans by a search that grows
    exponentially with the mesh's dims. The gradient flowing back into
    the product is gathered the same way."""
    x = gather_inner(x)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return gather_inner_grad(x @ w)


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------

def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * p["scale"]).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Rotates the two halves
    of the head dim (not interleaved pairs), in float32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def full_attention(q, k, v, *, causal: bool = True,
                   window: int | None = None, q_offset: int = 0):
    """Unblocked attention over (B, H, S, hd), kv heads broadcast (small
    shapes and oracles only); probabilities rounded to v's dtype before
    the second product, as in ``repro``."""
    H, K = q.shape[1], k.shape[1]
    if K != H:
        k = k.repeat_interleave(H // K, dim=1)
        v = v.repeat_interleave(H // K, dim=1)
    sq, skv, hd = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def attention_params(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    dt = getattr(torch, cfg.param_dtype)
    specs = {"wq": dense_spec((d, H * hd), dt),
             "wk": dense_spec((d, K * hd), dt),
             "wv": dense_spec((d, K * hd), dt),
             "wo": dense_spec((H * hd, d), dt)}
    if cfg.use_bias:
        specs["bq"] = ((H * hd,), dt, "zeros")
        specs["bo"] = ((d,), dt, "zeros")
    return specs


def _project_qkv(p: Params, x, xkv, cfg: ModelConfig, positions,
                 kv_positions, *, use_rope: bool):
    """q (B, H, S, hd) from ``x``; k and v (B, K, Skv, hd) from ``xkv``;
    RoPE'd at ``positions`` and ``kv_positions`` when ``use_rope``."""
    B, S, _ = x.shape
    skv = xkv.shape[1]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = mm(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = split_last(q, H, hd)
    k = split_last(mm(xkv, p["wk"]), K, hd)
    v = split_last(mm(xkv, p["wv"]), K, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return (lshard(q.transpose(1, 2), "batch", "heads", "seq", "head_dim"),
            lshard(k.transpose(1, 2), "batch", "kv_heads", "seq", "head_dim"),
            lshard(v.transpose(1, 2), "batch", "kv_heads", "seq", "head_dim"))


def _out_proj(p: Params, o):
    out = mm(o, p["wo"])
    if "bo" in p:
        out = out + p["bo"]
    return out


def attention_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      kind: str = "attn", positions=None,
                      encoder_out: torch.Tensor | None = None,
                      return_kv: bool = False):
    """Prefill attention through the flash kernel. kind: attn | local
    (sliding window of ``cfg.local_window``) | cross (K/V from
    ``encoder_out``, no RoPE, not causal: Skv is the encoder's length)."""
    if kind not in ("attn", "local", "cross"):
        raise ValueError(f"unknown attention kind {kind!r}")
    cross = kind == "cross"
    if cross and encoder_out is None:
        raise ValueError("cross attention needs encoder_out")
    S = x.shape[1]
    xkv = encoder_out if cross else x
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    kv_positions = (torch.arange(xkv.shape[1], device=x.device)[None, :]
                    if cross else positions)
    q, k, v = _project_qkv(p, x, xkv, cfg, positions, kv_positions,
                           use_rope=not cross)
    k, v = k.contiguous(), v.contiguous()
    window = cfg.local_window if kind == "local" else None
    out = local_call(flash_attention, q.contiguous(), k, v, lead=2,
                     causal=not cross, window=window)
    out = _out_proj(p, merge_last(out.transpose(1, 2)))
    out = lshard(out, "batch", "seq", "embed")
    if not return_kv:
        return out
    return out, (lshard(k, "batch", None, "kv_seq", "head_dim"),
                 lshard(v, "batch", None, "kv_seq", "head_dim"))


def attention_decode(p: Params, x: torch.Tensor, cache: dict,
                     cfg: ModelConfig, *, kind: str = "attn"):
    """One token against a KV cache: ``cache = {"k": (B, K, Smax, hd),
    "v": ..., "len": int}``, one length for the whole batch.

    The cache is a ring buffer (slot = position mod Smax; RoPE is applied
    at write time with the absolute position). The new K/V are written
    into the cache tensors in place; the returned cache holds the same
    tensors and ``len + 1``. Scores and the weighted sum run in float32
    over bfloat16 K/V (a narrower cache dtype is upcast to bfloat16
    first), with the probabilities rounded to bfloat16, as in ``repro``.
    ``kind`` is ``"attn"`` or ``"local"``: cross attention decodes
    through ``model._cross_decode``.
    """
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = int(cache["len"])
    positions = torch.full((B, 1), pos, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, positions, positions,
                                   use_rope=True)
    ck = lshard(cache["k"], "batch", "kv_heads", "kv_seq", "head_dim")
    cv = lshard(cache["v"], "batch", "kv_heads", "kv_seq", "head_dim")
    smax = ck.shape[2]
    ins = pos % smax
    ck[:, :, ins] = k_new[:, :, 0].to(ck.dtype)
    cv[:, :, ins] = v_new[:, :, 0].to(cv.dtype)
    ck_m = ck if ck.dtype == torch.bfloat16 else ck.to(torch.bfloat16)
    cv_m = cv if cv.dtype == torch.bfloat16 else cv.to(torch.bfloat16)

    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                     ck_m.float()) / math.sqrt(hd)
    kpos = torch.arange(smax, device=x.device)
    # before the ring wraps only slots <= pos are written; after, all are
    valid = (kpos <= pos) | (pos >= smax)
    if kind == "local" and cfg.local_window < smax:
        valid &= kpos > pos - cfg.local_window
    s = torch.where(valid, s, NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).to(cv_m.dtype)
    o = torch.einsum("bkgs,bksd->bkgd", probs.float(), cv_m.float())
    out = _out_proj(p, o.reshape(B, 1, H * hd).to(x.dtype))
    return out, {"k": ck, "v": cv, "len": pos + 1}


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                         dtype=torch.bfloat16, device=None) -> dict:
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros(batch, K, max_len, hd, dtype=dtype,
                             device=device),
            "v": torch.zeros(batch, K, max_len, hd, dtype=dtype,
                             device=device),
            "len": 0}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(cfg: ModelConfig) -> dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    if cfg.act == "swiglu":
        return {"w_gate": dense_spec((d, f), dt),
                "w_up": dense_spec((d, f), dt),
                "w_down": dense_spec((f, d), dt)}
    return {"w_up": dense_spec((d, f), dt),
            "w_down": dense_spec((f, d), dt)}


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig):
    if "w_gate" in p:
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
    else:                           # jax.nn.gelu is the tanh approximation
        h = F.gelu(mm(x, p["w_up"]), approximate="tanh")
    h = lshard(h, "batch", "seq", "ff")
    return lshard(mm(h, p["w_down"]), "batch", "seq", "embed")
