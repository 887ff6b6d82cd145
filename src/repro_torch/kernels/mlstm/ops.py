"""Public mLSTM wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

Same contract as ``repro.kernels.mlstm.ops.mlstm``: q, k, v (BH, S, hd)
in any float dtype, log_i, log_f (BH, S), h (BH, S, hd) in float32, from
a zero state. ``chunk`` is ``repro``'s chunk length: ``min(chunk, S)``
must divide S, else :class:`ValueError` (where ``repro`` asserts). The
function does not depend on the chunking, so the kernel walks S in its
own tiles. A CUDA tensor goes to the kernel or the call raises; there is
no fallback.

:func:`mlstm` carries ``launches``: the number of times it launched its
kernel. CPU calls do not count.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.mlstm import kernel
from repro_torch.kernels.mlstm.ref import mlstm_ref

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
    out = kernel.mlstm_chunkwise(q, k, v, log_i, log_f)
    with _count_lock:
        mlstm.launches += 1
    return out


mlstm.launches = 0
