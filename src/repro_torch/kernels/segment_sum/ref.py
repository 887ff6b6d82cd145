"""Plain PyTorch versions of the masked segment SUM and MIN/MAX.

The counterparts of ``repro/kernels/segment_sum/ref.py``. A CPU tensor
takes these paths (``ops.py``), the tests hold them against the JAX
functions, and ``chip_smoke.py`` holds the CUDA kernels against them on
the card. Nothing on the card's path calls them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["reduce_identity", "masked_segment_sum_ref",
           "masked_segment_reduce_ref", "numpy_dtype"]


def reduce_identity(dtype, op: str):
    """Identity element for a masked segment MIN/MAX over ``dtype``.

    Invalid (and NaN) lanes are replaced with this value before the
    reduction so they cannot win; an all-identity segment is a NULL
    result (the caller masks it via the counts output).
    """
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return dtype.type(np.inf if op == "min" else -np.inf)
    info = np.iinfo(dtype)
    return dtype.type(info.max if op == "min" else info.min)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def _lanes(segment_ids, valid, num_segments: int):
    ids = segment_ids.long()
    return ids, valid & (ids >= 0) & (ids < num_segments)


def _count(ids, lanes, num_segments: int):
    return torch.bincount(ids[lanes], minlength=num_segments).to(torch.int32)


def masked_segment_sum_ref(values, segment_ids, valid,
                           num_segments: int):
    """Per-segment SUM over valid lanes + per-segment valid-lane counts.

    values: (n,) numeric; segment_ids: (n,) int32; valid: (n,) bool.
    Lanes with an id outside ``[0, num_segments)`` contribute nothing.
    Returns (sums (num_segments,) values.dtype, counts (num_segments,)
    int32); integer sums wrap in the value dtype, like numpy's.
    """
    ids, lanes = _lanes(segment_ids, valid, num_segments)
    # integers add in int64 and wrap to the value dtype at the end (the
    # same sum modulo 2**bits); narrow integer atomics on the card would
    # serialize on a shared word
    acc = torch.int64 if not values.dtype.is_floating_point else values.dtype
    sums = torch.zeros(num_segments, dtype=acc, device=values.device)
    sums.index_add_(0, ids[lanes], values[lanes].to(acc))
    return sums.to(values.dtype), _count(ids, lanes, num_segments)


def _order_keys(values):
    """int64 keys that order like the values (with -0.0 below +0.0), so
    the extreme reduces with 64-bit integer atomics on the card."""
    if not values.dtype.is_floating_point:
        return values.long()
    wide = values.element_size() == 8
    bits = values.view(torch.int64 if wide else torch.int32).long()
    mask = 0x7FFFFFFFFFFFFFFF if wide else 0x7FFFFFFF
    return torch.where(bits < 0, bits ^ mask, bits)


def _from_order_keys(keys, dtype):
    if not dtype.is_floating_point:
        return keys.to(dtype)
    wide = torch.empty(0, dtype=dtype).element_size() == 8
    mask = 0x7FFFFFFFFFFFFFFF if wide else 0x7FFFFFFF
    bits = torch.where(keys < 0, keys ^ mask, keys)
    return bits.to(torch.int64 if wide else torch.int32).view(dtype)


def masked_segment_reduce_ref(values, segment_ids, valid,
                              num_segments: int, op: str):
    """Per-segment MIN/MAX over valid lanes + valid-lane counts.

    A NaN in a valid lane poisons its segment; an empty segment holds
    the identity. Of the lanes that tie for the extreme, the LATER row
    wins, as with ``np.minimum(acc, v)`` row by row: that decides the
    sign of a tied ``±0.0``.
    """
    ident = reduce_identity(numpy_dtype(values.dtype), op).item()
    ids, lanes = _lanes(segment_ids, valid, num_segments)
    isnan = values != values                 # all-False for int dtypes
    clean = lanes & ~isnan
    red = torch.full((num_segments,), ident, dtype=values.dtype,
                     device=values.device)
    if bool(clean.any()):
        cid, cval = ids[clean], values[clean]
        best = _from_order_keys(_order_keys(red).scatter_reduce(
            0, cid, _order_keys(cval),
            reduce="amin" if op == "min" else "amax"), values.dtype)
        rows = torch.arange(len(values), device=values.device)[clean]
        tie = cval == best[cid]              # -0.0 == 0.0: both tie
        last = torch.full((num_segments,), -1, dtype=torch.long,
                          device=values.device).scatter_reduce(
            0, cid[tie], rows[tie], reduce="amax")
        has = last >= 0
        red[has] = values[last[has]]
    if values.dtype.is_floating_point:
        nans = _count(ids, lanes & isnan, num_segments)
        red[nans > 0] = float("nan")
    return red, _count(ids, lanes, num_segments)
