"""Public wrappers: the CUDA kernels for a CUDA tensor, the plain
versions for a CPU tensor.

Same signatures as ``repro.kernels.segment_sum.ops``. A CUDA tensor goes
to the kernels or the call raises; there is no fallback. An integer SUM
and every MIN/MAX need no order: integer atomics give the same bits in
any order. A float SUM takes rows in run order, so the wrapper first
brings them into it with the stable radix partition (``kernel.run_order``:
every step in a fixed order, so float sums are the same bits every
launch). No torch sort, gather or scatter runs on the card's path.

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
    if values.dtype in kernel.INT_DTYPES:
        out = kernel.segment_sum_atomic(values, segment_ids, valid,
                                        num_segments)
    else:
        out = kernel.segment_sum(*kernel.run_order(
            values, segment_ids, valid, num_segments), num_segments)
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
    out = kernel.segment_reduce(values, segment_ids, valid, num_segments,
                                op)
    with _count_lock:
        masked_segment_reduce.launches += 1
    return out


masked_segment_sum.launches = 0
masked_segment_reduce.launches = 0
