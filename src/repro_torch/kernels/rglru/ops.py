"""Public RG-LRU scan wrapper: the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor.

Same contract as ``repro.kernels.rglru.ops.rglru_scan`` (float32 (B, S,
W) in and out), plus the initial state of ``repro.models.rglru._lru_scan``:
``h0`` is folded into the first step, ``b[:, 0] + a[:, 0] * h0``, before
the scan. A CUDA tensor goes to the kernel or the call raises; there is
no fallback.

Gradients: when grad mode is on and ``a`` or ``b`` requires a gradient,
a CUDA call goes through an ``autograd.Function`` whose forward is the
same kernel launch and whose backward recomputes h through the plain
scan under autograd (``kernels/autograd.py``); otherwise it is the bare
launch. A CPU call runs the plain scan, which autograd differentiates as
it is.

:func:`rglru_scan` carries ``launches``: the number of times it launched
its kernel. CPU calls and backward recomputes do not count.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.autograd import meta_call, recompute_grads, wants_grad
from repro_torch.kernels.rglru import kernel
from repro_torch.kernels.rglru.ref import rglru_scan_ref

__all__ = ["rglru_scan"]

_count_lock = threading.Lock()


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1, from ``h0`` (or zeros)."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one (B, S, W) shape")
    if h0 is not None:
        if h0.shape != (a.shape[0], a.shape[2]):
            raise ValueError(f"h0 {tuple(h0.shape)} does not fit "
                             f"{tuple(a.shape)}")
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    devices = {a.device, b.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type == "meta":         # element-wise: no products
        return meta_call("rglru_scan", a.shape, torch.float32, 0, 0, a, b)
    if wants_grad(a, b):
        return _RglruKernel.apply(a, b)
    return _launch(a, b)


def _launch(a, b) -> torch.Tensor:
    out = kernel.rglru_scan(a, b)
    with _count_lock:
        rglru_scan.launches += 1
    return out


class _RglruKernel(torch.autograd.Function):
    """The kernel forward; the backward by recomputing the plain scan
    under autograd."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _launch(a, b)

    @staticmethod
    def backward(ctx, dh):
        return recompute_grads(rglru_scan_ref, ctx, dh)


rglru_scan.launches = 0
