"""Bind the CUDA flash attention kernels (``csrc/flash_attention.cu``).

The source is built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``). Nothing is
built or loaded when this module is imported. The wrapper allocates the
output and launches on PyTorch's current stream.

Three kernels compute the same function; :data:`KERNELS` says which
one takes a (dtype, q/k head dim, v head dim), and anything outside it
raises: ``wgmma`` (bf16 at hd 64/96/128/256, tensor cores fed by TMA;
at hd 96, phi3-vision's, in TMA boxes of 32 columns under the 64-byte
swizzle), ``mla`` (the same design at qk 192 and v 128, latent
attention's, with its own ``__global__``, ``flash_mla_kernel``) and
``simt`` (float32 at every head dim, bf16 at hd 16/32, the float32 FMA
units). Every call passes its softmax scale, ``1/sqrt(hd)`` unless the
caller gives another.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

__all__ = ["build", "flash_attention", "kernel_for", "SOURCE", "HEAD_DIMS",
           "KERNELS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 96, 128, 256)
# (dtype, q/k head dim, v head dim) -> the kernel that takes it; nothing
# else is taken
KERNELS = {
    **{(torch.float32, hd, hd): "simt" for hd in HEAD_DIMS},
    **{(torch.bfloat16, hd, hd): "simt" for hd in (16, 32)},
    **{(torch.bfloat16, hd, hd): "wgmma" for hd in (64, 96, 128, 256)},
    (torch.bfloat16, 192, 128): "mla",
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = [ptr, ptr, ptr, ptr, i, i, i, i, i,
                                          i, i, i, i, ctypes.c_float, ptr]
    lib.repro_flash_attention.restype = i
    lib.repro_flash_attention_wgmma.argtypes = [
        ptr, ptr, ptr, ptr, i, i, i, i, i, i, i, i, i, ctypes.c_float, ptr]
    lib.repro_flash_attention_wgmma.restype = i
    lib.repro_flash_attention_error_string.argtypes = [i]
    lib.repro_flash_attention_error_string.restype = ctypes.c_char_p


_LIBRARY = CudaLibrary(SOURCE, "flash_attention", _bind)


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernel if this source has no library yet (see
    :func:`repro_torch.kernels.build.build`)."""
    return _LIBRARY.build(ptxas_report=ptxas_report)


def kernel_for(dtype: torch.dtype, hd: int, hd_v: int | None = None) -> str:
    """The kernel that takes q and k of ``dtype`` and head dim ``hd``,
    and v of head dim ``hd_v`` (default ``hd``) (:data:`KERNELS`);
    raises for any other."""
    if dtype not in _DTYPES:
        raise TypeError(f"the kernels take float32 or bfloat16, not {dtype}")
    hd_v = hd if hd_v is None else hd_v
    name = KERNELS.get((dtype, hd, hd_v))
    if name is None:
        if hd_v == hd:
            raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
        raise ValueError(f"head dims {hd} (q, k) and {hd_v} (v) are not "
                         f"taken: {sorted(k[1:] for k in KERNELS)}")
    return name


def _check(q, k, v) -> str:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on the CUDA device of q "
                             f"({dev}), got {t.device}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    B, H, _, hd = q.shape
    name = kernel_for(q.dtype, hd, v.shape[3])
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    return name


def flash_attention(q, k, v, *, causal: bool, window: int | None,
                    scale: float | None = None):
    """Attention forward on the card: q (B, H, Sq, hd), k (B, K, Skv,
    hd), v (B, K, Skv, hd_v), K | H; output (B, H, Sq, hd_v) in q's
    dtype, scores times ``scale`` (default ``1/sqrt(hd)``). Returns
    (output, the kernel's name)."""
    name = _check(q, k, v)
    lib = _LIBRARY.load()
    B, H, sq, hd = q.shape
    out = q.new_empty((B, H, sq, v.shape[3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    mask = (int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(hd) if scale is None else float(scale))
    shape = (B, H, k.shape[1], sq, k.shape[2], hd)
    with torch.cuda.device(q.device):
        if name == "simt":
            rc = lib.repro_flash_attention(*args, _DTYPES[q.dtype], *shape,
                                           *mask, stream)
        else:
            rc = lib.repro_flash_attention_wgmma(*args, *shape, v.shape[3],
                                                 *mask, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: "
            f"{lib.repro_flash_attention_error_string(rc).decode()}")
    return out, name
