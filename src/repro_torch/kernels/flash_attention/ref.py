"""Plain PyTorch version of the flash attention forward.

The counterpart of ``repro/kernels/flash_attention/ref.py``: the whole
score matrix at once, in float32, masked with the finite ``-1e30`` (so a
row that sees no key never turns into NaN), softmax, and the output cast
back to q's dtype. k/v may have fewer heads than q (GQA): query head
``h`` reads kv head ``h // (H // K)``.

A CPU tensor takes this path (``ops.py``), the tests hold it against the
JAX functions, and ``chip_smoke.py`` holds the CUDA kernel against it on
the card. It materializes (B, H, Sq, Skv) scores: for checks, not for
the card's path.

:func:`flash_attention_bwd_ref` is the backward that ``repro``'s flash
attention differentiates through (``models/layers.py``,
``_flash_mha_bwd``), in plain PyTorch: it recomputes P from q and k one
block of queries at a time, so it holds (B, H, block, Skv) scores, not
the whole matrix; the kernel wrapper's backward on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "band_mask", "flash_attention_ref",
           "flash_attention_bwd_ref"]

NEG_INF = -1e30


def band_mask(sq: int, skv: int, *, causal: bool, window: int | None,
              device=None) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query sees."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, K, Skv, hd) with K | H. float32 math,
    output in q's dtype."""
    H, K = q.shape[1], k.shape[1]
    if H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv "
                         f"heads")
    if K != H:
        k = k.repeat_interleave(H // K, dim=1)
        v = v.repeat_interleave(H // K, dim=1)
    sq, skv, hd = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    mask = band_mask(sq, skv, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, dout, *, causal: bool = True,
                            window: int | None = None, block_q: int = 512):
    """(dq, dk, dv) of attention at (q, k, v) against ``dout``, in float32
    math, each in its input's dtype. ``out`` is the forward's output:
    its row sums ``delta = sum(dout * out)`` correct the softmax's
    Jacobian, as in ``repro``. GQA kv heads sum their query heads'
    gradients."""
    B, H, sq, hd = q.shape
    K, skv = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv "
                         f"heads")
    rep = H // K
    scale = 1.0 / math.sqrt(hd)
    qf, do = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    delta = (do * out.float()).sum(-1)                       # (B, H, Sq)
    mask = band_mask(sq, skv, causal=causal, window=window, device=q.device)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for lo in range(0, sq, block_q):
        rows = slice(lo, min(lo + block_q, sq))
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows], kf) * scale
        p = torch.softmax(torch.where(mask[rows], s, NEG_INF), dim=-1)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, do[:, :, rows])
        dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, rows], vf)
        ds = p * (dp - delta[:, :, rows, None]) * scale
        dq[:, :, rows] = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qf[:, :, rows])
    if rep > 1:
        dk = dk.view(B, K, rep, skv, hd).sum(2)
        dv = dv.view(B, K, rep, skv, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
