"""Bind the CUDA decode attention kernels (``csrc/decode_attention.cu``).

The source is built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``). Nothing is
built or loaded when this module is imported. The wrapper allocates the
output and one scratch buffer (the scores, the chunks' softmax pairs,
the chunks' partial sums) and launches the three kernels on PyTorch's
current stream.

The live slots are split into chunks so that the scores and weights
kernels each run about :data:`WAVES` waves of blocks on the card (from
the card's own occupancy of the scores kernel), with at least
:data:`MIN_CHUNK` slots a chunk.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

__all__ = ["build", "decode_attention", "split", "SOURCE", "HEAD_DIMS",
           "HEAD_GROUP", "KERNELS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
HEAD_GROUP = 4          # query heads of one kv head a block takes
KERNELS = ("scores", "weights", "combine")   # one launch each a call
WAVES = 8
MIN_CHUNK = 64


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_decode_attention.argtypes = [ptr, i, ptr, ptr, ptr, ptr] + [
        i] * 8 + [ctypes.c_float, ptr]
    lib.repro_decode_attention.restype = i
    lib.repro_decode_attention_resident.argtypes = [
        i, ctypes.POINTER(ctypes.c_int)]
    lib.repro_decode_attention_resident.restype = i
    lib.repro_decode_attention_error_string.argtypes = [i]
    lib.repro_decode_attention_error_string.restype = ctypes.c_char_p


_LIBRARY = CudaLibrary(SOURCE, "decode_attention", _bind)
_RESIDENT: dict[tuple[int, int], int] = {}


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernels if this source has no library yet (see
    :func:`repro_torch.kernels.build.build`)."""
    return _LIBRARY.build(ptxas_report=ptxas_report)


def _error(lib, rc: int) -> str:
    return lib.repro_decode_attention_error_string(rc).decode()


def _resident(lib, device: torch.device, hd: int) -> int:
    key = (device.index, hd)
    if key not in _RESIDENT:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.repro_decode_attention_resident(hd, ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"decode attention occupancy query failed: "
                               f"{_error(lib, rc)}")
        _RESIDENT[key] = n.value
    return _RESIDENT[key]


def split(live: int, blocks: int, resident: int) -> tuple[int, int]:
    """(splits, chunk) for ``live`` slots over ``blocks`` (b·kv head, head
    group) pairs on a card that holds ``resident`` blocks at once: about
    :data:`WAVES` waves, chunks of at least :data:`MIN_CHUNK` slots, and
    every chunk non-empty."""
    splits = max(1, min(math.ceil(WAVES * resident / blocks),
                        live // MIN_CHUNK))
    chunk = math.ceil(live / splits)
    return math.ceil(live / chunk), chunk


def _check(q, k, v) -> None:
    """Raise for anything the kernels do not take; shapes and dtypes
    first, then the device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    B, K, g, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, not {t.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or tuple(k.shape[:2]) != (B, K) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if min(B, K, g) < 1:
        raise ValueError(f"empty q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on one CUDA device, got "
                             f"{t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def _floats16(n: int) -> int:
    """``n`` float32s rounded up to a 16-byte multiple."""
    return -(-n // 4) * 4


def decode_attention(q, k, v, *, lo: int, live: int) -> torch.Tensor:
    """Attention of q (B, K, g, hd) float32 or bfloat16 over slots ``lo
    .. lo + live - 1`` of k, v (B, K, Smax, hd) bfloat16 on the card:
    (B, K, g, hd) float32."""
    _check(q, k, v)
    B, K, g, hd = q.shape
    smax = k.shape[2]
    if lo < 0 or live < 1 or lo + live > smax:
        raise ValueError(f"slots {lo} .. {lo + live - 1} are not in a "
                         f"cache of {smax}")
    lib = _LIBRARY.load()
    blocks = B * K * math.ceil(g / HEAD_GROUP)
    splits, chunk = split(live, blocks, _resident(lib, q.device, hd))
    # scratch: the scores (B*K, g, live), the chunks' (max, sum) pairs
    # (B*K, splits, g, 2) and partial sums (B*K, splits, g, hd), float32
    scratch = torch.empty(
        _floats16(B * K * g * live) + _floats16(B * K * splits * g * 2)
        + B * K * splits * g * hd, dtype=torch.float32, device=q.device)
    out = torch.empty(B, K, g, hd, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.repro_decode_attention(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
            v.data_ptr(), scratch.data_ptr(), out.data_ptr(), B * K, g, smax,
            hd, lo, live, splits, chunk, math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"{_error(lib, rc)}")
    return out
