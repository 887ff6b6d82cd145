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
``repro``'s. Decode is a one-token softmax over a ring-buffer KV cache,
plain ``jnp`` in ``repro``; here it goes through the decode attention
kernels (:func:`repro_torch.kernels.decode_attention.ops.
decode_attention`), which read the cache's live slots only, with
``repro``'s arithmetic.

Multi-head latent attention (DeepSeek-V2; ``repro`` has none) is
:class:`MLA`, :func:`mla_forward`, :func:`mla_decode` and
:func:`mla_cache_init`: its prefill goes through the flash kernel at
qk 192 / v 128 and hands a latent cache entry on; its decode reads that
latent cache in the absorbed form.

Dtypes follow ``repro``: activations in ``cfg.dtype``; a product of a
tensor with a parameter of another dtype is taken in the promoted dtype,
as JAX promotes; norms, RoPE and softmax in float32; logits from
bfloat16 operands come out in float32 (``preferred_element_type``),
computed here by upcasting before the product.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (gather_inner, gather_inner_grad,
                                              local_call, lshard, merge_last,
                                              split_last, write_slot)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.obs import get_recorder

__all__ = ["NEG_INF", "ParamModule", "mm", "rmsnorm", "rope",
           "full_attention", "attention_params", "attention_forward",
           "attention_decode", "attention_cache_init", "MLA", "yarn_inv_freq",
           "mla_softmax_scale", "rope_yarn", "mla_forward", "mla_decode",
           "mla_cache_init", "mlp_params", "mlp_forward"]

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
    over bfloat16 K/V (a cache of another dtype is cast to bfloat16
    first), with the probabilities rounded to bfloat16, as in ``repro``
    (``kernels/decode_attention``: on the card over the live slots only).
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
    write_slot(ck, 2, ins, k_new[:, :, 0].to(ck.dtype))
    write_slot(cv, 2, ins, v_new[:, :, 0].to(cv.dtype))
    ck_m = ck if ck.dtype == torch.bfloat16 else ck.to(torch.bfloat16)
    cv_m = cv if cv.dtype == torch.bfloat16 else cv.to(torch.bfloat16)

    o = decode_attention(q.reshape(B, K, H // K, hd), ck_m, cv_m, pos=pos,
                         window=cfg.local_window if kind == "local" else None)
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
# multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLA(ParamModule):
    """The latent mixer's parameters: ``wq`` (d, H·(nope + rope)), no q
    LoRA; ``wkv_a`` (d, r + rope), the joint down-projection to the
    latent and the shared RoPE key; ``kv_norm.scale`` (r,) float32, the
    latent's RMSNorm; ``wkv_b`` (r, H·(nope + v)), the up-projection to
    each head's key and value; ``wo`` (H·v, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        a, d, H = cfg.mla, cfg.d_model, cfg.num_heads
        r = a.kv_lora_rank
        dt = getattr(torch, cfg.param_dtype)
        super().__init__({
            "wq": dense_spec((d, H * a.qk_head_dim), dt),
            "wkv_a": dense_spec((d, r + a.qk_rope_head_dim), dt),
            "wkv_b": dense_spec((r, H * (a.qk_nope_head_dim + a.v_head_dim)),
                                dt),
            "wo": dense_spec((H * a.v_head_dim, d), dt)}, device)
        self.kv_norm = ParamModule({"scale": ((r,), torch.float32, "ones")},
                                   device)


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: ModelConfig, device=None) -> torch.Tensor:
    """The YaRN frequencies of the RoPE dims, (rope / 2,) float64:
    ``f_extra = theta^(-2i/rope)`` where a dim turns often within the
    original context, ``f_extra / factor`` where it turns less than
    once, and a linear ramp between the correction dims that
    ``beta_fast`` and ``beta_slow`` rotations give (10 and 23 at
    DeepSeek-V2-Lite's sizes). Made once per device and kept: the
    caller must not write into it."""
    a = cfg.mla
    return _yarn_inv_freq(a.qk_rope_head_dim, cfg.rope_theta, a.rope_factor,
                          a.rope_original_max_position, a.rope_beta_fast,
                          a.rope_beta_slow,
                          None if device is None else torch.device(device))


@functools.lru_cache(maxsize=16)
def _yarn_inv_freq(dim: int, base: float, factor: float, original: int,
                   beta_fast: float, beta_slow: float, device):
    def corr(rot):
        return (dim * math.log(original / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    with torch.inference_mode(False), torch.no_grad():
        extra = base ** (-torch.arange(0, dim, 2, dtype=torch.float64,
                                       device=device) / dim)
        lo = max(math.floor(corr(beta_fast)), 0)
        hi = min(math.ceil(corr(beta_slow)), dim - 1)
        hi = hi + 0.001 if lo == hi else hi
        ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
                 - lo) / (hi - lo)).clamp(0, 1)
        keep = 1 - ramp
        return extra / factor * (1 - keep) + extra * keep


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """``qk_head_dim^-1/2``, times YaRN's ``mscale_all_dim`` factor
    squared: 0.114721 at DeepSeek-V2-Lite's sizes."""
    a = cfg.mla
    return (a.qk_head_dim ** -0.5
            * _yarn_mscale(a.rope_factor, a.rope_mscale_all_dim) ** 2)


def rope_yarn(x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, heads, rope); positions: (B, S). The published layout:
    the rope dims de-interleaved (pairs (2i, 2i+1) to i and rope/2 + i),
    then the two halves rotated at :func:`yarn_inv_freq`, angles in
    float64, the product in float32 (YaRN's cos/sin multiplier is 1:
    ``MLAConfig``)."""
    return _rotate_yarn(x, *_yarn_cos_sin(positions, cfg, x.device))


def _yarn_cos_sin(positions: torch.Tensor, cfg: ModelConfig, device):
    """The cos and sin of :func:`rope_yarn`'s angles, (B, S, 1, rope /
    2) each: one table serves a layer's query and key."""
    angles = (positions[..., None].double()
              * yarn_inv_freq(cfg, device)).float()          # (B, S, half)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rotate_yarn(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    B, S, heads, dim = x.shape
    xf = x.float().reshape(B, S, heads, dim // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _kv_norm(p: Params, c: torch.Tensor, eps: float) -> torch.Tensor:
    """The latent's RMSNorm."""
    return rmsnorm(p["kv_norm"], c, eps)


def _mla_project(p: Params, x: torch.Tensor, cfg: ModelConfig, positions):
    """q_nope (B, S, H, nope), q_pe (B, S, H, rope) after RoPE; the
    normed latent c (B, S, r); k_pe (B, S, 1, rope) after RoPE."""
    a = cfg.mla
    B, S, _ = x.shape
    H, nope, r = cfg.num_heads, a.qk_nope_head_dim, a.kv_lora_rank
    q = mm(x, p["wq"]).view(B, S, H, a.qk_head_dim)
    kv_a = mm(x, p["wkv_a"])
    c = _kv_norm(p, kv_a[..., :r], cfg.norm_eps)
    cos, sin = _yarn_cos_sin(positions, cfg, x.device)
    k_pe = _rotate_yarn(kv_a[..., None, r:], cos, sin)
    return q[..., :nope], _rotate_yarn(q[..., nope:], cos, sin), c, k_pe


def _count_cache(*entry: torch.Tensor) -> None:
    """``mla.cache_bytes``: the bytes of the cache entry handed on."""
    rec = get_recorder()
    if rec.enabled:
        rec.metrics.counter("mla.cache_bytes").inc(
            sum(t.numel() * t.element_size() for t in entry))


def mla_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                return_kv: bool = False):
    """Prefill latent attention, causal, through the flash kernel at qk
    ``nope + rope`` and v ``v_head_dim`` with :func:`mla_softmax_scale`.
    With ``return_kv``, also the cache entry ``(c, k_pe)``: the normed
    latent (B, 1, S, r) and the RoPE'd key (B, 1, S, rope)."""
    a = cfg.mla
    B, S, _ = x.shape
    H, nope, vd = cfg.num_heads, a.qk_nope_head_dim, a.v_head_dim
    rec = get_recorder()
    with rec.span("mla.project"):
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        q_nope, q_pe, c, k_pe = _mla_project(p, x, cfg, positions)
        kv = mm(c, p["wkv_b"]).view(B, S, H, nope + vd)
        # the kernel's (B, H, S, qk) layout, each part written once
        q = q_nope.new_empty((B, H, S, a.qk_head_dim))
        q[..., :nope].copy_(q_nope.transpose(1, 2))
        q[..., nope:].copy_(q_pe.transpose(1, 2))
        k = kv.new_empty((B, H, S, a.qk_head_dim))
        k[..., :nope].copy_(kv[..., :nope].transpose(1, 2))
        k[..., nope:].copy_(k_pe.transpose(1, 2))  # one RoPE key, all heads
        v = kv[..., nope:].transpose(1, 2).contiguous()
    with rec.span("mla.core"):
        o = flash_attention(q, k, v, causal=True, scale=mla_softmax_scale(cfg))
    out = mm(o.transpose(1, 2).reshape(B, S, H * vd), p["wo"])
    if not return_kv:
        return out
    entry = (c[:, None], k_pe.transpose(1, 2))
    _count_cache(*entry)
    return out, entry


def mla_decode(p: Params, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One token against the latent cache ``{"c": (B, 1, Smax, r),
    "k_pe": (B, 1, Smax, rope), "len": int}``, a ring as
    :func:`attention_decode`'s (slot = position mod Smax). The new
    entry is written in place; the core is the absorbed form in float32
    over the live slots: ``q_lat = q_nope W_uk^T`` (H, r), scores
    ``q_lat c + q_pe k_pe`` times the scale, ``o = (p c) W_uv``."""
    a = cfg.mla
    B = x.shape[0]
    H, nope, vd, r = (cfg.num_heads, a.qk_nope_head_dim, a.v_head_dim,
                      a.kv_lora_rank)
    pos = int(cache["len"])
    rec = get_recorder()
    with rec.span("mla.project"):
        positions = torch.full((B, 1), pos, device=x.device)
        q_nope, q_pe, c, k_pe = _mla_project(p, x, cfg, positions)
        cc, ck = cache["c"], cache["k_pe"]
        smax = cc.shape[2]
        write_slot(cc, 2, pos % smax, c.to(cc.dtype))
        write_slot(ck, 2, pos % smax, k_pe[:, :, 0].to(ck.dtype))
        _count_cache(cc.select(2, pos % smax), ck.select(2, pos % smax))
    with rec.span("mla.core"):
        live = min(pos + 1, smax)
        lat = cc[:, 0, :live].float()                        # (B, T, r)
        w = p["wkv_b"].float().view(r, H, nope + vd)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(),
                             w[..., :nope])
        s = (torch.einsum("bhr,btr->bht", q_lat, lat)
             + torch.einsum("bhe,bte->bht", q_pe[:, 0].float(),
                            ck[:, 0, :live].float()))
        prob = torch.softmax(s * mla_softmax_scale(cfg), dim=-1)
        o_lat = torch.einsum("bht,btr->bhr", prob, lat)
        o = torch.einsum("bhr,rhv->bhv", o_lat, w[..., nope:])
    out = mm(o.reshape(B, 1, H * vd).to(x.dtype), p["wo"])
    return out, {"c": cc, "k_pe": ck, "len": pos + 1}


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    """A latent ring of ``max_len`` slots: ``kv_lora_rank +
    qk_rope_head_dim`` values a token (576 at DeepSeek-V2-Lite's)."""
    a = cfg.mla
    return {"c": torch.zeros(batch, 1, max_len, a.kv_lora_rank, dtype=dtype,
                             device=device),
            "k_pe": torch.zeros(batch, 1, max_len, a.qk_rope_head_dim,
                                dtype=dtype, device=device),
            "len": 0}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(cfg: ModelConfig, d_ff: int | None = None) -> dict[str, tuple]:
    """An MLP of width ``d_ff`` (default ``cfg.d_ff``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
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
