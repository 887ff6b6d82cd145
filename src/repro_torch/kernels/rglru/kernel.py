"""Bind the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The source is built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``). Nothing is
built or loaded when this module is imported. The wrapper allocates the
output and launches on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

__all__ = ["build", "rglru_scan", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rglru_scan.argtypes = [ptr, ptr, ptr, i, i, i, ptr]
    lib.repro_rglru_scan.restype = i
    lib.repro_rglru_scan_error_string.argtypes = [i]
    lib.repro_rglru_scan_error_string.restype = ctypes.c_char_p


_LIBRARY = CudaLibrary(SOURCE, "rglru_scan", _bind)


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernel if this source has no library yet (see
    :func:`repro_torch.kernels.build.build`)."""
    return _LIBRARY.build(ptxas_report=ptxas_report)


def rglru_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 of (B, S, W) float32
    tensors on the card, from h = 0."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must lie on the CUDA device of a "
                             f"({a.device}), got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D tensor")
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    B, S, W = a.shape
    if max(B * S * W, 0) >= 2**62 or B > 65535:
        raise ValueError(f"shape {tuple(a.shape)} too large")
    lib = _LIBRARY.load()
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        rc = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                  B, S, W, stream)
    if rc != 0:
        raise RuntimeError(
            f"RG-LRU scan kernel launch failed: "
            f"{lib.repro_rglru_scan_error_string(rc).decode()}")
    return h
