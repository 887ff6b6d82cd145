"""Plain PyTorch version of the RG-LRU linear recurrence.

The counterpart of ``repro/kernels/rglru/ref.py``: h_t = a_t * h_{t-1} +
b_t, one step at a time along S, each product and sum rounded on its own.
The CUDA kernel does the same arithmetic in the same order, so on the
card the two agree bit for bit. A CPU tensor takes this path
(``ops.py``); on the card the kernel wrapper's backward recomputes h
through it under autograd, and checks call it. Each step's h is kept in
a list and stacked, so autograd holds no in-place copies.
"""
from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref"]


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """a, b: (B, S, W) float32; h0: (B, W) or None (zeros)."""
    h = h0 if h0 is not None else torch.zeros_like(a[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1) if out else torch.empty_like(b)
