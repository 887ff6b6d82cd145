"""Gradients through the model kernels, which have no backward kernel.

``repro`` writes only forward kernels in Pallas and trains through XLA
forms of the same functions. The port does the same: each model
kernel's wrapper (``flash_attention``, ``mlstm``, ``rglru_scan``) takes,
when grad mode is on and an input requires a gradient, an
``autograd.Function`` whose forward is the unchanged kernel launch and
whose backward is plain PyTorch. Without that, a CUDA call through a
``ctypes``-bound kernel returns a tensor with no ``grad_fn``, and a loss
through it would silently give no gradient to anything upstream.

On ``meta`` tensors (a dry-run counts a step without running it) each
wrapper returns an empty output through :func:`meta_call`, which reports
the kernel's forward FLOPs, and its backward's, to a running
``roofline.analysis.analyze_step``.
"""
from __future__ import annotations

import torch

__all__ = ["wants_grad", "recompute_grads", "meta_call"]


def wants_grad(*inputs: torch.Tensor) -> bool:
    """Grad mode is on and some input requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def recompute_grads(plain, ctx, dout) -> tuple:
    """The gradients of ``plain(*ctx.saved_tensors)`` against ``dout``,
    for the saved inputs that need one (None for the rest): the forward
    recomputed through ``plain`` under autograd. ``plain`` returns the
    output, or a tuple whose first element is it."""
    inputs = [t.detach().requires_grad_(need) for t, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        out = plain(*inputs)
        out = out[0] if isinstance(out, tuple) else out
        grads = iter(torch.autograd.grad(
            out, [t for t in inputs if t.requires_grad], dout))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


class _MetaKernel(torch.autograd.Function):
    """A kernel call on ``meta``: an empty output, FLOPs reported."""

    @staticmethod
    def forward(ctx, name, out_like, fwd_flops, bwd_flops, *inputs):
        from repro_torch.roofline.analysis import count_kernel_flops
        count_kernel_flops(name, fwd_flops)
        ctx.name, ctx.bwd_flops = name, bwd_flops
        ctx.likes = [(t.shape, t.dtype) for t in inputs]
        return torch.empty(out_like[0], dtype=out_like[1], device="meta")

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.roofline.analysis import count_kernel_flops
        count_kernel_flops(f"{ctx.name}.backward", ctx.bwd_flops)
        return (None, None, None, None, *(
            torch.empty(shape, dtype=dtype, device="meta")
            for shape, dtype in ctx.likes))


def meta_call(name: str, out_shape, out_dtype, fwd_flops: float,
              bwd_flops: float, *inputs: torch.Tensor) -> torch.Tensor:
    """The output of kernel ``name`` on ``meta`` inputs, shaped
    ``out_shape``: no work, ``fwd_flops`` counted now and ``bwd_flops``
    when autograd runs its backward (the plain backward the wrapper's
    ``autograd.Function`` would run)."""
    return _MetaKernel.apply(name, (tuple(out_shape), out_dtype), fwd_flops,
                             bwd_flops, *inputs)
