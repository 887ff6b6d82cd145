"""Public mLSTM wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

Same contract as ``repro.kernels.mlstm.ops.mlstm``: q, k, v (BH, S, hd)
in any float dtype, log_i, log_f (BH, S), h (BH, S, hd) in float32, from
a zero state. ``chunk`` is ``repro``'s chunk length: ``min(chunk, S)``
must divide S, else :class:`ValueError` (where ``repro`` asserts). The
function does not depend on the chunking, so the kernel walks S in its
own tiles. A CUDA tensor goes to the kernel or the call raises; there is
no fallback.

Gradients: the kernel has no backward. When grad mode is on and an
input requires a gradient, a CUDA call goes through an
``autograd.Function`` whose forward is the same kernel launch and whose
backward recomputes h through the plain chunk-parallel form
(:func:`~repro_torch.kernels.mlstm.ref.mlstm_two_pass_ref`, the kernel's
own algebra) and takes ``torch.autograd.grad`` of it; ``repro`` trains
through its XLA chunk in the same way. Otherwise the call is the bare
launch. A CPU call runs the plain recurrence, which autograd
differentiates as it is.

:func:`mlstm` carries ``launches``: the number of times it launched its
kernel. CPU calls and backward recomputes do not count.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.autograd import meta_call, recompute_grads, wants_grad
from repro_torch.kernels.mlstm import kernel
from repro_torch.kernels.mlstm.ref import mlstm_ref, mlstm_two_pass_ref

__all__ = ["mlstm"]

_count_lock = threading.Lock()


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_i: torch.Tensor, log_f: torch.Tensor, *,
          chunk: int = 256) -> torch.Tensor:
    """The chunkwise mLSTM forward; see the module docstring."""
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, hd), got {tuple(q.shape)}")
    S = q.shape[1]
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"the chunk ({chunk}) must divide S ({S})")
    devices = {t.device for t in (q, k, v, log_i, log_f)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if q.device.type == "cpu":
        return mlstm_ref(q, k, v, log_i, log_f)
    inputs = (q, k, v, log_i, log_f)
    if q.device.type == "meta":
        BH, S, hd = q.shape
        # 4·hd² + 4·hd per (b·h, step); the backward recomputes the
        # two-pass form and differentiates it: three times the forward
        flops = (4 * hd * hd + 4 * hd) * BH * S
        return meta_call("mlstm_chunkwise", q.shape, torch.float32, flops,
                         3 * flops, *inputs)
    if wants_grad(*inputs):
        return _MlstmKernel.apply(*inputs)
    return _launch(*inputs)


def _launch(q, k, v, log_i, log_f) -> torch.Tensor:
    out = kernel.mlstm_chunkwise(q, k, v, log_i, log_f)
    with _count_lock:
        mlstm.launches += 1
    return out


class _MlstmKernel(torch.autograd.Function):
    """The kernel forward; the backward by recomputing the plain
    chunk-parallel form under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f):
        ctx.save_for_backward(q, k, v, log_i, log_f)
        return _launch(q, k, v, log_i, log_f)

    @staticmethod
    def backward(ctx, dh):
        return recompute_grads(mlstm_two_pass_ref, ctx, dh)


mlstm.launches = 0
