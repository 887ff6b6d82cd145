"""Bind the CUDA hash-probe kernels (``csrc/hash_probe.cu``).

The source is built at first use by :mod:`repro_torch.kernels.build`
(``nvcc`` for ``sm_90a``, a plain C interface, ``ctypes``). Nothing is
built or loaded when this module is imported. The wrappers allocate the
outputs and launch on PyTorch's current stream.

The kernel takes 4 lanes at a time in 16-byte loads and stores. The
outputs are allocated at the slots' 16-byte phase, and
:func:`lane_split` says which lanes take the 16-byte body and which the
scalar head and tail; the grid's block cap is read once per device.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BUILD_DIR, CudaLibrary

__all__ = ["build", "hash_probe", "masked_hash_probe", "lane_split",
           "SOURCE", "BUILD_DIR", "BLOCKS_PER_SM"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "hash_probe.cu"
# the grid's cap, in blocks of 256 threads per SM (examples/probe_tune.py
# times it against a grid sized from n)
BLOCKS_PER_SM = 4


def _bind(lib: ctypes.CDLL) -> None:
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_hash_probe.argtypes = [ptr, ptr, ptr, ptr, ll, i, ll, i, ptr,
                                     ptr, ptr]
    lib.repro_hash_probe.restype = i
    lib.repro_hash_probe_error_string.argtypes = [i]
    lib.repro_hash_probe_error_string.restype = ctypes.c_char_p


_LIBRARY = CudaLibrary(SOURCE, "hash_probe", _bind)


def build(*, ptxas_report: bool = False) -> tuple[Path, str]:
    """Compile the kernels if this source has no library yet (see
    :func:`repro_torch.kernels.build.build`)."""
    return _LIBRARY.build(ptxas_report=ptxas_report)


def lane_split(n: int, slots_ptr: int, mask_ptr: int | None,
               starts_ptr: int, counts_ptr: int) -> tuple[int, int]:
    """``(head, groups)`` for ``n`` lanes at these addresses: lanes
    ``[0, head)`` and ``[head + 4 * groups, n)`` take the kernel's scalar
    path, group ``g`` lanes ``head + 4g .. head + 4g + 3`` its 16-byte
    body, where slots, starts and counts are 16-byte aligned and the mask
    4-byte aligned. When no lane aligns them all, every lane is scalar:
    ``(n, 0)``."""
    head = (-slots_ptr // 4) % 4          # int32 lanes to a 16-byte line
    if (head >= n or slots_ptr % 4
            or (starts_ptr + 4 * head) % 16 or (counts_ptr + 4 * head) % 16
            or (mask_ptr is not None and (mask_ptr + head) % 4)):
        return n, 0
    return head, (n - head) // 4


@functools.cache
def _grid_cap(index: int) -> int:
    """The grid's cap on device ``index``, from its SM count (read once
    per device)."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


def _empty_at_phase(slots: torch.Tensor) -> torch.Tensor:
    """An output like the (n,) int32 ``slots`` at their 16-byte phase (a
    view into n + 3 lanes when the slots are not 16-byte aligned)."""
    phase = (slots.data_ptr() // 4) % 4
    if phase == 0:
        return torch.empty_like(slots)
    return torch.empty(slots.shape[0] + phase, dtype=torch.int32,
                       device=slots.device)[phase:]


def _check(table_start, table_count, slots, mask) -> None:
    dev = slots.device
    for name, t in (("table_start", table_start),
                    ("table_count", table_count), ("probe_slots", slots),
                    ("probe_mask", mask)):
        if t is None:
            continue
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must lie on the CUDA device of "
                             f"probe_slots ({dev}), got {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if t.dtype != (torch.bool if t is mask else torch.int32):
            raise TypeError(f"{name} must be "
                            f"{'bool' if t is mask else 'int32'}, not "
                            f"{t.dtype}")
    if table_count.shape != table_start.shape:
        raise ValueError("table_start and table_count differ in length")
    if mask is not None and mask.shape != slots.shape:
        raise ValueError("probe_mask and probe_slots differ in length")
    if table_start.shape[0] >= 2**31:
        raise ValueError(f"table of {table_start.shape[0]} slots exceeds "
                         f"int32")


def _launch(table_start, table_count, slots, mask):
    _check(table_start, table_count, slots, mask)
    lib = _LIBRARY.load()
    dev = slots.device
    n = slots.shape[0]
    slots_ptr = slots.data_ptr()
    mask_ptr = None if mask is None else mask.data_ptr()
    starts = _empty_at_phase(slots)
    counts = _empty_at_phase(slots)
    head, _ = lane_split(n, slots_ptr, mask_ptr, starts.data_ptr(),
                         counts.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        rc = lib.repro_hash_probe(
            slots_ptr, mask_ptr, table_start.data_ptr(),
            table_count.data_ptr(), n, table_start.shape[0], head,
            _grid_cap(dev.index), starts.data_ptr(), counts.data_ptr(),
            stream)
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
