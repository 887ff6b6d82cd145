"""Which numpy dtypes lower losslessly to a CUDA tensor.

The twin of ``repro/kernels/fallback.py``'s ``device_supports_dtype``.
Torch has native 64-bit integers and floats, so there is no x64 flag:
int64 and float64 stay on the device. Object columns and non-numeric
kinds never lower; unsigned types wider than 8 bits have partial op
coverage in torch and take the host path until a test shows they are
covered.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DEVICE_DTYPES", "device_supports_dtype"]

DEVICE_DTYPES = frozenset(np.dtype(t) for t in (
    np.int8, np.int16, np.int32, np.int64, np.uint8,
    np.float32, np.float64))


def device_supports_dtype(dtype) -> bool:
    """Can a column of ``dtype`` run on the device without losing bits?
    Callers that get ``False`` take the host (numpy) path, which is the
    same semantic routing the JAX backend does for object columns."""
    return np.dtype(dtype) in DEVICE_DTYPES
