"""Bind the CUDA segment kernels (``csrc/segment_sum.cu``).

The source is built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``). Nothing is
built or loaded when this module is imported.

``segment_sum_atomic`` sums integers and ``segment_reduce`` takes
MIN/MAX in any row order, with integer atomics. ``segment_sum`` sums
floats over rows in run order (ids sorted, non-decreasing), which
``run_order`` brings arbitrary ids into with a stable radix partition.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import BUILD_DIR, CudaLibrary

__all__ = ["build", "segment_sum", "segment_reduce", "segment_sum_atomic",
           "run_order", "INT_DTYPES", "SOURCE", "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_sum.cu"

# dtype codes of segment_sum.cu's DType enum
_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
          torch.uint8: 4, torch.float32: 5, torch.float64: 6}
_OPS = {"min": 1, "max": 2}
INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_segment_scratch_bytes.argtypes = [ll]
    lib.repro_segment_scratch_bytes.restype = ll
    lib.repro_segment_sum.argtypes = [
        i, ptr, ptr, ptr, ll, i, ptr, ptr, ptr, ptr]
    lib.repro_segment_sum.restype = i
    lib.repro_segment_reduce_atomic.argtypes = [
        i, i, ptr, ptr, ptr, ll, i, ptr, ptr, ptr, ptr]
    lib.repro_segment_reduce_atomic.restype = i
    lib.repro_segment_atomic_scratch_bytes.argtypes = [ll]
    lib.repro_segment_atomic_scratch_bytes.restype = ll
    lib.repro_segment_sum_atomic.argtypes = [
        i, ptr, ptr, ptr, ll, i, ptr, ptr, ptr, ptr]
    lib.repro_segment_sum_atomic.restype = i
    lib.repro_run_order_scratch_bytes.argtypes = [i, ll, i]
    lib.repro_run_order_scratch_bytes.restype = ll
    lib.repro_run_order.argtypes = [
        i, ptr, ptr, ptr, ll, i, ptr, ptr, ptr, ptr, ptr]
    lib.repro_run_order.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


_LIBRARY = CudaLibrary(SOURCE, "segment_sum", _bind)


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernels if this source has no library yet (see
    :func:`repro_torch.kernels.build.build`)."""
    return _LIBRARY.build(ptxas_report=ptxas_report)


def _check(values: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
           num_segments: int) -> None:
    for name, t in (("values", values), ("segment_ids", ids),
                    ("valid", valid)):
        if t.device.type != "cuda" or t.device != values.device:
            raise ValueError(
                f"{name} must lie on the CUDA device of values "
                f"({values.device}), got {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if len(t) != len(values):
            raise ValueError(f"{name} has {len(t)} rows, values "
                             f"{len(values)}")
    if values.dtype not in _CODES:
        raise TypeError(f"the segment kernels take "
                        f"{sorted(map(str, _CODES))}, not {values.dtype}")
    if ids.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("segment_ids must be int32 and valid bool")
    if not 0 <= num_segments < 2**31 - 1:
        raise ValueError(f"num_segments {num_segments} out of range")
    if len(values) >= 2**31:
        raise ValueError(f"{len(values)} rows: the kernels take < 2^31")


def _raise(lib, what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.repro_cuda_error_string(rc).decode()}")


def segment_sum(values, ids, valid, num_segments: int):
    """Masked segment SUM of float values over run-ordered rows on the
    card: (sums (S,) values.dtype, counts (S,) int32)."""
    _check(values, ids, valid, num_segments)
    if values.dtype in INT_DTYPES:
        raise TypeError("the run-order SUM takes floats; integers go to "
                        "segment_sum_atomic")
    lib = _LIBRARY.load()
    dev = values.device
    n = len(values)
    out = torch.empty(num_segments, dtype=values.dtype, device=dev)
    counts = torch.empty(num_segments, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.repro_segment_scratch_bytes(n),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.repro_segment_sum(
            _CODES[values.dtype], values.data_ptr(), ids.data_ptr(),
            valid.data_ptr(), n, num_segments, out.data_ptr(),
            counts.data_ptr(), scratch.data_ptr(), stream)
    _raise(lib, "segment SUM kernel", rc)
    return out, counts


def segment_reduce(values, ids, valid, num_segments: int, op: str):
    """Masked segment MIN/MAX in any row order, with integer atomics on
    order-preserving keys: (reduced (S,) values.dtype, counts (S,)
    int32). The source picks the shape by S, as for the integer SUM."""
    _check(values, ids, valid, num_segments)
    if op not in _OPS:
        raise ValueError(f"unknown segment reduce op: {op!r}")
    lib = _LIBRARY.load()
    dev = values.device
    out = torch.empty(num_segments, dtype=values.dtype, device=dev)
    counts = torch.empty(num_segments, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.repro_segment_atomic_scratch_bytes(
        num_segments), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.repro_segment_reduce_atomic(
            _CODES[values.dtype], _OPS[op], values.data_ptr(),
            ids.data_ptr(), valid.data_ptr(), len(values), num_segments,
            out.data_ptr(), counts.data_ptr(), scratch.data_ptr(), stream)
    _raise(lib, f"segment {op} kernel", rc)
    return out, counts


def segment_sum_atomic(values, ids, valid, num_segments: int):
    """Masked segment SUM of integer values in any row order, with
    integer atomics: (sums (S,) values.dtype, counts (S,) int32). The
    source picks the kernel's shape by S."""
    _check(values, ids, valid, num_segments)
    if values.dtype not in INT_DTYPES:
        raise TypeError(f"the atomic SUM takes integers, not {values.dtype}")
    lib = _LIBRARY.load()
    dev = values.device
    out = torch.empty(num_segments, dtype=values.dtype, device=dev)
    counts = torch.empty(num_segments, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.repro_segment_atomic_scratch_bytes(
        num_segments) if values.element_size() < 4 else 0,
        dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.repro_segment_sum_atomic(
            _CODES[values.dtype], values.data_ptr(), ids.data_ptr(),
            valid.data_ptr(), len(values), num_segments, out.data_ptr(),
            counts.data_ptr(), scratch.data_ptr(), stream)
    _raise(lib, "segment atomic SUM", rc)
    return out, counts


def run_order(values, ids, valid, num_segments: int):
    """(values, ids, valid) in run order, stably: rows by key (id in [0,
    S) ? id : S), row order kept within a key; ids outside [0, S) come
    back as S. A radix partition over the bits the keys need."""
    _check(values, ids, valid, num_segments)
    lib = _LIBRARY.load()
    dev = values.device
    n, item = len(values), values.element_size()
    v_out, i_out, m_out = (torch.empty_like(t) for t in (values, ids, valid))
    scratch = torch.empty(lib.repro_run_order_scratch_bytes(
        item, n, num_segments), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.repro_run_order(
            item, values.data_ptr(), ids.data_ptr(), valid.data_ptr(), n,
            num_segments, v_out.data_ptr(), i_out.data_ptr(),
            m_out.data_ptr(), scratch.data_ptr(), stream)
    _raise(lib, "run-order partition", rc)
    return v_out, i_out, m_out
