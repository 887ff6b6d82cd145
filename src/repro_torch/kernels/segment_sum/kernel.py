"""Build and bind the CUDA segment kernels (``csrc/segment_sum.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/repro_torch/``
at the root of the checkout (a directory ``.gitignore`` lists), and bound
with ``ctypes``. The library's name carries a hash of the source, so an
edited source is never served a stale build. Nothing is built or loaded
when this module is imported.

The wrappers here take rows in run order (ids sorted, non-decreasing) on
the card; ``ops.py`` brings arbitrary ids into that order.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["build", "segment_sum", "segment_reduce", "SOURCE", "BUILD_DIR"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "segment_sum.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# dtype codes of segment_sum.cu's DType enum
_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
          torch.uint8: 4, torch.float32: 5, torch.float64: 6}
_OPS = {"min": 1, "max": 2}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA segment kernels cannot be built")
    return found


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernels if this source has no library yet. Returns
    the library's path and the compiler's output; ``ptxas_report``
    rebuilds with ``-Xptxas -v``, whose output lists each kernel's
    registers, shared memory and spills."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libsegment_sum-{digest}.so"
    if lib.exists() and not ptxas_report:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS,
           *(("-Xptxas", "-v") if ptxas_report else ()),
           "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)     # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.repro_segment_scratch_bytes.argtypes = [ll]
            lib.repro_segment_scratch_bytes.restype = ll
            lib.repro_segment_sum.argtypes = [
                i, ptr, ptr, ptr, ll, i, ptr, ptr, ptr, ptr]
            lib.repro_segment_sum.restype = i
            lib.repro_segment_reduce.argtypes = [
                i, i, ptr, ptr, ptr, ll, i, ptr, ptr, ptr, ptr]
            lib.repro_segment_reduce.restype = i
            lib.repro_cuda_error_string.argtypes = [i]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


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
    if not 0 <= num_segments < 2**31:
        raise ValueError(f"num_segments {num_segments} out of range")


def _launch(op: str, values, ids, valid, num_segments: int):
    _check(values, ids, valid, num_segments)
    lib = _library()
    dev = values.device
    n = len(values)
    out = torch.empty(num_segments, dtype=values.dtype, device=dev)
    counts = torch.empty(num_segments, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.repro_segment_scratch_bytes(n),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (values.data_ptr(), ids.data_ptr(), valid.data_ptr(), n,
            num_segments, out.data_ptr(), counts.data_ptr(),
            scratch.data_ptr(), stream)
    code = _CODES[values.dtype]
    with torch.cuda.device(dev):
        rc = (lib.repro_segment_sum(code, *args) if op == "sum"
              else lib.repro_segment_reduce(code, _OPS[op], *args))
    if rc != 0:
        raise RuntimeError(
            f"segment {op} kernel launch failed: "
            f"{lib.repro_cuda_error_string(rc).decode()}")
    return out, counts


def segment_sum(values, ids, valid, num_segments: int):
    """Masked segment SUM over run-ordered rows on the card:
    (sums (S,) values.dtype, counts (S,) int32)."""
    return _launch("sum", values, ids, valid, num_segments)


def segment_reduce(values, ids, valid, num_segments: int, op: str):
    """Masked segment MIN/MAX over run-ordered rows on the card:
    (reduced (S,) values.dtype, counts (S,) int32)."""
    return _launch(op, values, ids, valid, num_segments)
