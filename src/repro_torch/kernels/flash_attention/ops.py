"""Public flash attention wrapper: the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor.

Same contract as ``repro.kernels.flash_attention.ops.flash_attention``:
q (B, H, Sq, hd), k/v (B, K, Skv, hd) with K | H, causal and/or a
sliding window, output in q's dtype. Beyond it, for latent attention:
v's head dim may differ from q's and k's (the output takes v's), and
``scale`` replaces the default ``1/sqrt(hd)``. GQA is folded into the kernel's
indexing (kv head ``h // (H // K)``), not by repeating k and v. A CUDA
tensor goes to the kernel or the call raises; there is no fallback.

Gradients: when grad mode is on and q, k or v requires a gradient, a
CUDA call goes through an ``autograd.Function`` whose forward is the
same kernel launch and whose backward is plain PyTorch
(:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_bwd_ref`):
what ``repro``'s flash backward (``_flash_mha_bwd``) computes,
recomputing P from the inputs, with the kernel's output for the
softmax's row correction. Otherwise the call is the bare launch. A CPU
call runs the plain version, which autograd differentiates as it is.

:func:`flash_attention` carries ``launches``: the number of times it
launched a kernel, and ``launches_by_kernel``: the same by the kernel's
name (``kernel.KERNELS``). CPU calls and backward passes do not count.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.autograd import meta_call, wants_grad
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

__all__ = ["flash_attention"]

_count_lock = threading.Lock()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Multi-head attention forward; see the module docstring."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, heads, S, hd)")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type == "meta":
        B, H, sq, hd = q.shape
        skv, hd_v = k.shape[2], v.shape[3]
        # the kernel: 2·(hd + hd_v) per live pair (4·hd at one head dim);
        # the plain backward recomputes P and takes four more products
        # over every (query, key) block
        return meta_call("flash_attention", (B, H, sq, hd_v), q.dtype,
                         2 * (hd + hd_v) * live_pairs(sq, skv, causal, window)
                         * B * H, 5 * (hd + hd_v) * sq * skv * B * H, q, k, v)
    if wants_grad(q, k, v):
        return _FlashKernel.apply(q, k, v, causal, window, scale)
    return _launch(q, k, v, causal, window, scale)


def live_pairs(sq: int, skv: int, causal: bool, window: int | None) -> int:
    """The (query, key) pairs ``band_mask`` keeps, counted without it."""
    i = torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(i, max=skv - 1) if causal else torch.full_like(i, skv - 1)
    lo = torch.clamp(i - window + 1, min=0) if window is not None \
        else torch.zeros_like(i)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def _launch(q, k, v, causal, window, scale) -> torch.Tensor:
    out, name = kernel.flash_attention(q, k, v, causal=causal, window=window,
                                       scale=scale)
    with _count_lock:
        flash_attention.launches += 1
        flash_attention.launches_by_kernel[name] += 1
    return out


class _FlashKernel(torch.autograd.Function):
    """The kernel forward; the plain flash backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale=None):
        out = _launch(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, dout,
                                             causal=causal, window=window,
                                             scale=scale)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_attention.launches_by_kernel = {"wgmma": 0, "simt": 0, "mla": 0}
