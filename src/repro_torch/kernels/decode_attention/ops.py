"""Public decode attention wrapper: the CUDA kernels for a CUDA tensor,
the plain version for a CPU one.

One query token against a ring KV cache: q (B, K, g, hd), the g query
heads of each kv head; k, v (B, K, Smax, hd) bfloat16; the query at
absolute position ``pos``; ``window`` for local attention. Output (B, K,
g, hd) float32, as ``ref.decode_attention_ref`` computes it.

The slots the plain version's mask keeps are always one contiguous range
(:func:`live_range`): the written slots of the ring, cut to the window.
The kernels read those slots and no others. q is read in float32 or
bfloat16 and widened to float32 (exactly) in the kernel; another dtype
is cast to float32 first. When no slot is valid (a window shorter
than the cache, long after the ring wrapped) the plain version's softmax
is uniform over every slot; the kernels get that from a zero query over
all of them.

A CPU or ``meta`` tensor takes the plain version, a DTensor too. A CUDA
tensor goes to the kernels or the call raises; there is no fallback. A
DTensor on the card raises: under the decode rules the cache is sharded
over its slots, and the kernels would need a cross-rank exchange of the
chunks' (max, sum) pairs between their passes, which they do not have
yet (PERF.md, section 7 (f)).

:func:`decode_attention` carries ``launches``: the number of calls that
launched the kernels, each call one launch of each of the three kernels
(``kernel.KERNELS``). CPU calls do not count.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.distributed.sharding import _is_dtensor
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "live_range"]

_count_lock = threading.Lock()


def live_range(pos: int, smax: int, window: int | None) -> tuple[int, int]:
    """(lo, hi): the slots ``ref.valid_slots`` keeps are ``lo .. hi``;
    ``lo > hi`` when it keeps none."""
    hi = min(pos, smax - 1)
    lo = 0
    if window is not None and window < smax:
        lo = max(0, pos - window + 1)
    return lo, hi


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     pos: int, window: int | None = None) -> torch.Tensor:
    """Decode attention; see the module docstring."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    on_card = q.device.type not in ("cpu", "meta")
    if on_card and any(map(_is_dtensor, (q, k, v))):
        raise NotImplementedError(
            "decode attention on sharded (DTensor) tensors on the card: the "
            "kernels lack the cross-rank exchange of their chunks' (max, "
            "sum) pairs (PERF.md, section 7 (f))")
    if not on_card:
        return decode_attention_ref(q, k, v, pos=pos, window=window)
    smax = k.shape[2]
    lo, hi = live_range(pos, smax, window)
    if q.dtype not in (torch.float32, torch.bfloat16):
        q = q.float()
    if lo > hi:
        q, lo, hi = torch.zeros_like(q), 0, smax - 1
    out = kernel.decode_attention(q.contiguous(), k, v, lo=lo,
                                  live=hi - lo + 1)
    with _count_lock:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
