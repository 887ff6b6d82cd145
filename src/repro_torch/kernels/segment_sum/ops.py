"""Public wrappers: the CUDA kernels for a CUDA tensor, the plain
versions for a CPU tensor.

Same signatures as ``repro.kernels.segment_sum.ops``. A CUDA tensor goes
to the kernel or the call raises; there is no fallback. The kernels take
rows in run order, so the wrapper first sorts the ids stably on the
device (row order within a segment is kept, which the MIN/MAX tie rule
needs) and gathers values and validity to match.

Each function carries ``launches``: the number of times it launched its
kernel. CPU calls do not count.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.segment_sum import kernel
from repro_torch.kernels.segment_sum.ref import (masked_segment_reduce_ref,
                                                 masked_segment_sum_ref)

__all__ = ["masked_segment_sum", "masked_segment_reduce"]

_count_lock = threading.Lock()   # the engine runs a wave's nodes in threads


def _check(values, segment_ids, valid) -> None:
    if values.dim() != 1 or segment_ids.shape != values.shape \
            or valid.shape != values.shape:
        raise ValueError("values, segment_ids and valid must be 1-D and "
                         "of one length")
    if segment_ids.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("segment_ids must be int32 and valid bool")
    devices = {values.device, segment_ids.device, valid.device}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _run_order(values, segment_ids, valid):
    ids, perm = torch.sort(segment_ids, stable=True)
    return values[perm], ids, valid[perm]


def masked_segment_sum(values, segment_ids, valid, num_segments: int):
    """Per-segment SUM over valid lanes + valid-lane counts.

    values: (n,) int8/16/32/64, uint8, float32/64; segment_ids: (n,)
    int32 (ids outside ``[0, num_segments)`` contribute nothing); valid:
    (n,) bool. Returns (sums (num_segments,) values.dtype, counts
    (num_segments,) int32). Float sums are bitwise the same on every run.
    """
    _check(values, segment_ids, valid)
    if values.device.type == "cpu":
        return masked_segment_sum_ref(values, segment_ids, valid,
                                      num_segments)
    out = kernel.segment_sum(*_run_order(values, segment_ids, valid),
                             num_segments)
    with _count_lock:
        masked_segment_sum.launches += 1
    return out


def masked_segment_reduce(values, segment_ids, valid, num_segments: int,
                          *, op: str):
    """Per-segment MIN/MAX over valid lanes + valid-lane counts.

    ``op`` is ``"min"`` or ``"max"``. A NaN in a valid lane poisons its
    segment, an empty segment holds the identity, and of tied values the
    later row wins (the sign of a tied ``±0.0``), as in the reference.
    """
    if op not in ("min", "max"):
        raise ValueError(f"unknown segment reduce op: {op!r}")
    _check(values, segment_ids, valid)
    if values.device.type == "cpu":
        return masked_segment_reduce_ref(values, segment_ids, valid,
                                         num_segments, op)
    out = kernel.segment_reduce(*_run_order(values, segment_ids, valid),
                                num_segments, op)
    with _count_lock:
        masked_segment_reduce.launches += 1
    return out


masked_segment_sum.launches = 0
masked_segment_reduce.launches = 0
