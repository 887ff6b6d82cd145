"""Build and load a CUDA source of the port with ``nvcc`` and ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled for
``sm_90a`` into a shared library at first use, into ``build/repro_torch/``
at the root of the checkout (a directory ``.gitignore`` lists), and
loaded with ``ctypes``. The library's name carries a hash of the source,
so an edited source is never served a stale build, and the finished
library is moved into place with one atomic ``os.replace``, so builds
that race agree. Nothing is built or loaded when this module is
imported.
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
from typing import Callable

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "build"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels cannot be built")
    return found


def build(source: Path, stem: str, *, ptxas_report: bool = False
          ) -> tuple[Path, str]:
    """Compile ``source`` into ``lib{stem}-{hash}.so`` if this source
    has no library yet. Returns the library's path and the compiler's
    output; ``ptxas_report`` rebuilds with ``-Xptxas -v``, whose output
    lists each kernel's registers, shared memory and spills."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{stem}-{digest}.so"
    if lib.exists() and not ptxas_report:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS,
           *(("-Xptxas", "-v") if ptxas_report else ()),
           "-o", tmp, str(source)]
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


class CudaLibrary:
    """One CUDA source, built and loaded once per process on first use.

    ``bind`` sets the ``argtypes``/``restype`` of the loaded library's C
    functions. Loading is under a lock: the engine runs a wave's nodes
    on threads, and two of them may reach their first launch together.
    """

    def __init__(self, source: Path, stem: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.stem = stem
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None

    def build(self, *, ptxas_report: bool = False) -> tuple[Path, str]:
        return build(self.source, self.stem, ptxas_report=ptxas_report)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()[0]))
                self._bind(lib)
                self._lib = lib
            return self._lib
