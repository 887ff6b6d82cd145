"""Bind the CUDA hash-probe kernels (``csrc/hash_probe.cu``).

The source is built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``). Nothing is
built or loaded when this module is imported. The wrappers allocate the
outputs and launch on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import BUILD_DIR, CudaLibrary

__all__ = ["build", "hash_probe", "masked_hash_probe", "SOURCE",
           "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "hash_probe.cu"


def _bind(lib: ctypes.CDLL) -> None:
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_hash_probe.argtypes = [ptr, ptr, ptr, ptr, ll, i, ptr, ptr,
                                     ptr]
    lib.repro_hash_probe.restype = i
    lib.repro_hash_probe_error_string.argtypes = [i]
    lib.repro_hash_probe_error_string.restype = ctypes.c_char_p


_LIBRARY = CudaLibrary(SOURCE, "hash_probe", _bind)


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernels if this source has no library yet (see
    :func:`repro_torch.kernels.build.build`)."""
    return _LIBRARY.build(ptxas_report=ptxas_report)


def _check(table_start, table_count, slots, mask) -> None:
    dev = slots.device
    named = [("table_start", table_start), ("table_count", table_count),
             ("probe_slots", slots)]
    if mask is not None:
        named.append(("probe_mask", mask))
    for name, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on the CUDA device of "
                             f"probe_slots ({dev}), got {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if name != "probe_mask" and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, not {t.dtype}")
    if table_count.shape != table_start.shape:
        raise ValueError("table_start and table_count differ in length")
    if mask is not None:
        if mask.dtype != torch.bool:
            raise TypeError(f"probe_mask must be bool, not {mask.dtype}")
        if mask.shape != slots.shape:
            raise ValueError("probe_mask and probe_slots differ in length")
    if len(table_start) >= 2**31:
        raise ValueError(f"table of {len(table_start)} slots exceeds int32")


def _launch(table_start, table_count, slots, mask):
    _check(table_start, table_count, slots, mask)
    lib = _LIBRARY.load()
    dev = slots.device
    n = len(slots)
    starts = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.repro_hash_probe(
            slots.data_ptr(), None if mask is None else mask.data_ptr(),
            table_start.data_ptr(), table_count.data_ptr(), n,
            len(table_start), starts.data_ptr(), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"hash probe kernel launch failed: "
            f"{lib.repro_hash_probe_error_string(rc).decode()}")
    return starts, counts


def hash_probe(table_start, table_count, probe_slots):
    """Per probe lane, ``(start, count)`` from the direct-address table
    on the card: two (n,) int32 tensors."""
    return _launch(table_start, table_count, probe_slots, None)


def masked_hash_probe(table_start, table_count, probe_slots, probe_mask):
    """:func:`hash_probe` with a bool keep mask: dropped lanes give
    ``(0, 0)``."""
    return _launch(table_start, table_count, probe_slots, probe_mask)
