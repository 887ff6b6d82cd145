"""Bind the CUDA chunkwise mLSTM kernel (``csrc/mlstm_chunkwise.cu``).

The source is built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``). Nothing is
built or loaded when this module is imported. The wrapper allocates the
float32 output and the states at the chunk starts (scratch), and launches
the kernel's three passes on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

__all__ = ["build", "mlstm_chunkwise", "SOURCE", "HEAD_DIMS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunkwise.cu"
HEAD_DIMS = (32, 64, 256)    # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_mlstm_scratch_bytes.argtypes = [i, i, i]
    lib.repro_mlstm_scratch_bytes.restype = ctypes.c_longlong
    lib.repro_mlstm_chunkwise.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i, i,
                                          i, i, ctypes.c_float, ptr, ptr]
    lib.repro_mlstm_chunkwise.restype = i
    lib.repro_mlstm_chunkwise_error_string.argtypes = [i]
    lib.repro_mlstm_chunkwise_error_string.restype = ctypes.c_char_p


_LIBRARY = CudaLibrary(SOURCE, "mlstm_chunkwise", _bind)


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernel if this source has no library yet (see
    :func:`repro_torch.kernels.build.build`)."""
    return _LIBRARY.build(ptxas_report=ptxas_report)


def _check(q, k, v, log_i, log_f) -> None:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("log_i", log_i),
                    ("log_f", log_f)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on the CUDA device of q "
                             f"({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 q, k, v, "
                        f"not {q.dtype}")
    for name, t in (("log_i", log_i), ("log_f", log_f)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be one (BH, S, hd) shape")
    if log_i.shape != q.shape[:2] or log_f.shape != q.shape[:2]:
        raise ValueError(f"log_i {tuple(log_i.shape)} and log_f "
                         f"{tuple(log_f.shape)} must be (BH, S) = "
                         f"{tuple(q.shape[:2])}")
    BH, S, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if BH > 65535 or S > 64 * 65535 or BH * S * hd >= 2**62:
        raise ValueError(f"shape {tuple(q.shape)} too large")


def mlstm_chunkwise(q, k, v, log_i, log_f):
    """The mLSTM's h (BH, S, hd) in float32 on the card, from q, k, v
    (BH, S, hd) of one float dtype and float32 log gates (BH, S)."""
    _check(q, k, v, log_i, log_f)
    lib = _LIBRARY.load()
    BH, S, hd = q.shape
    h = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    scratch = torch.empty(lib.repro_mlstm_scratch_bytes(BH, S, hd),
                          dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.repro_mlstm_chunkwise(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), h.data_ptr(), _DTYPES[q.dtype], BH, S, hd,
            1.0 / math.sqrt(hd), scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"mLSTM kernel launch failed: "
            f"{lib.repro_mlstm_chunkwise_error_string(rc).decode()}")
    return h
