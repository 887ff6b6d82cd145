"""Plain PyTorch version of decode attention over a ring KV cache.

One query token of each batch row against its cache, as ``repro``'s
``attention_decode`` computes it (``repro/models/layers.py``): scores
in float32 over bfloat16 K/V upcast to float32, masked to the slots the
ring has written (and to the local window), softmax in float32, the
normalised probabilities rounded to bfloat16, and the weighted sum in
float32.

A CPU or ``meta`` tensor, and a DTensor under the sharding rules, takes
this path (``ops.py``); the tests and ``chip_smoke.py`` hold the CUDA
kernel against it on the card. It materializes float32 copies of the
whole cache: for checks, not for the card's path.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "valid_slots", "decode_attention_ref"]

NEG_INF = -1e30


def valid_slots(pos: int, smax: int, window: int | None,
                device=None) -> torch.Tensor:
    """(Smax,) bool: the slots the query at position ``pos`` attends to."""
    kpos = torch.arange(smax, device=device)
    # before the ring wraps only slots <= pos are written; after, all are
    valid = (kpos <= pos) | (pos >= smax)
    if window is not None and window < smax:
        valid &= kpos > pos - window
    return valid


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, pos: int, window: int | None = None
                         ) -> torch.Tensor:
    """q (B, K, g, hd) in any float dtype; k, v (B, K, Smax, hd) bfloat16;
    the query at position ``pos``, a ``window`` for local attention.
    Returns (B, K, g, hd) float32."""
    hd, smax = q.shape[-1], k.shape[2]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(),
                     k.float()) / math.sqrt(hd)
    s = torch.where(valid_slots(pos, smax, window, q.device), s, NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bkgs,bksd->bkgd", probs.float(), v.float())
