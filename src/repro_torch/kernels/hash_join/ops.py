"""Public hash-probe wrappers: the CUDA kernels for a CUDA tensor, the
plain versions for a CPU tensor, and the numpy floor.

Same contract as ``repro.kernels.hash_join.ops``. A CUDA tensor goes to
the kernel or the call raises; there is no fallback. Each of
:func:`hash_probe` and :func:`masked_hash_probe` carries ``launches``:
the number of times it launched its kernel. CPU calls do not count.

:func:`hash_probe_np`, :func:`masked_hash_probe_np` and
:func:`build_probe_table_np` are the port's own copy of ``repro``'s
numpy floor: bit-identical to the plain versions, for host callers.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels.hash_join import kernel
from repro_torch.kernels.hash_join.ref import (hash_probe_ref,
                                               masked_hash_probe_ref)

__all__ = ["hash_probe", "masked_hash_probe", "hash_probe_np",
           "masked_hash_probe_np", "build_probe_table_np"]

_count_lock = threading.Lock()   # the engine runs a wave's nodes in threads


def _check(table_start, table_count, probe_slots, probe_mask=None) -> None:
    if table_start.dim() != 1 or table_count.shape != table_start.shape:
        raise ValueError("table_start and table_count must be 1-D and of "
                         "one length")
    if probe_slots.dim() != 1:
        raise ValueError("probe_slots must be 1-D")
    tensors = [table_start, table_count, probe_slots]
    if probe_mask is not None:
        if probe_mask.shape != probe_slots.shape:
            raise ValueError("probe_mask and probe_slots differ in length")
        tensors.append(probe_mask)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def hash_probe(table_start, table_count, probe_slots):
    """Per probe lane, the ``(start, count)`` of its match run in the
    slot-grouped build array; lanes whose slot lies outside
    ``[0, len(table_start))`` give ``(0, 0)``. int32 in, int32 out."""
    _check(table_start, table_count, probe_slots)
    if probe_slots.device.type == "cpu":
        return hash_probe_ref(table_start, table_count, probe_slots)
    out = kernel.hash_probe(table_start, table_count, probe_slots)
    with _count_lock:
        hash_probe.launches += 1
    return out


def masked_hash_probe(table_start, table_count, probe_slots, probe_mask):
    """Filter-fused probe: :func:`hash_probe` with a bool keep mask;
    dropped lanes give ``(0, 0)``."""
    _check(table_start, table_count, probe_slots, probe_mask)
    if probe_slots.device.type == "cpu":
        return masked_hash_probe_ref(table_start, table_count, probe_slots,
                                     probe_mask)
    out = kernel.masked_hash_probe(table_start, table_count, probe_slots,
                                   probe_mask)
    with _count_lock:
        masked_hash_probe.launches += 1
    return out


hash_probe.launches = 0
masked_hash_probe.launches = 0


# ---------------------------------------------------------------------------
# the numpy floor
# ---------------------------------------------------------------------------

def hash_probe_np(table_start: np.ndarray, table_count: np.ndarray,
                  probe_slots: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy version — same contract as :func:`hash_probe`."""
    table_size = len(table_start)
    slots = probe_slots.astype(np.int64, copy=False)
    ok = (slots >= 0) & (slots < table_size)
    idx = np.where(ok, slots, 0)
    if table_size == 0:
        z = np.zeros(len(probe_slots), np.int32)
        return z, z.copy()
    starts = np.where(ok, table_start[idx], 0).astype(np.int32)
    counts = np.where(ok, table_count[idx], 0).astype(np.int32)
    return starts, counts


def masked_hash_probe_np(table_start: np.ndarray,
                         table_count: np.ndarray,
                         probe_slots: np.ndarray,
                         probe_mask: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy version — same contract as :func:`masked_hash_probe`."""
    starts, counts = hash_probe_np(table_start, table_count, probe_slots)
    keep = probe_mask.astype(bool, copy=False)
    zero = np.int32(0)
    return (np.where(keep, starts, zero).astype(np.int32),
            np.where(keep, counts, zero).astype(np.int32))


def build_probe_table_np(slots_sorted: np.ndarray, table_size: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy version of :func:`~repro_torch.kernels.hash_join.ref.
    build_probe_table`."""
    s = slots_sorted.astype(np.int64, copy=False)
    in_range = (s >= 0) & (s < table_size)
    counts = np.bincount(s[in_range], minlength=table_size
                         ).astype(np.int32)
    starts = np.concatenate([np.zeros(1, np.int32),
                             np.cumsum(counts)[:-1].astype(np.int32)])
    return starts, counts
