"""Public flash attention wrapper: the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor.

Same contract as ``repro.kernels.flash_attention.ops.flash_attention``:
q (B, H, Sq, hd), k/v (B, K, Skv, hd) with K | H, causal and/or a
sliding window, output in q's dtype. GQA is folded into the kernel's
indexing (kv head ``h // (H // K)``), not by repeating k and v. A CUDA
tensor goes to the kernel or the call raises; there is no fallback.

:func:`flash_attention` carries ``launches``: the number of times it
launched a kernel, and ``launches_by_kernel``: the same by the kernel's
name (``kernel.KERNELS``). CPU calls do not count.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention"]

_count_lock = threading.Lock()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Multi-head attention forward; see the module docstring."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, heads, S, hd)")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    out, name = kernel.flash_attention(q, k, v, causal=causal, window=window)
    with _count_lock:
        flash_attention.launches += 1
        flash_attention.launches_by_kernel[name] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_kernel = {"wgmma": 0, "simt": 0}
