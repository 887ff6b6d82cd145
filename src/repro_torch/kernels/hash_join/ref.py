"""Plain PyTorch versions of the hash probe (the join's inner loop).

The counterparts of ``repro/kernels/hash_join/ref.py``. The probe
answers, for every probe lane, "where do my matches live?" against a
grouped build layout: a direct-address table of ``(start, count)`` per
key slot. The backends probe dense slot codes, so the hash is perfect
(slot = code - base) and one lookup per lane is the whole probe.

A CPU tensor takes these paths (``ops.py``), the tests hold them against
the JAX functions, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card. Nothing on the card's path calls them. int32 in,
int32 out: there is no float here and no tolerance.
"""
from __future__ import annotations

import torch

__all__ = ["build_probe_table", "hash_probe_ref", "masked_hash_probe_ref"]


def build_probe_table(slots_sorted: torch.Tensor, table_size: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(table_start, table_count)``, int32 arrays of ``table_size``.

    ``slots_sorted``: (m,) slot per build row, ascending over the rows
    whose slot lies in ``[0, table_size)``; other rows are dropped.
    Counts by ``bincount``, starts by the exclusive ``cumsum`` of the
    counts (valid because the rows are sorted by slot). An empty slot
    reads count 0.
    """
    s = slots_sorted.long()
    s = s[(s >= 0) & (s < table_size)]
    counts = torch.bincount(s, minlength=table_size).to(torch.int32)
    starts = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    return starts, counts


def hash_probe_ref(table_start: torch.Tensor, table_count: torch.Tensor,
                   probe_slots: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per probe lane, the ``(start, count)`` of its match run in the
    slot-grouped build array; a lane whose slot lies outside the table
    (NULL/NaN keys, another partition's keys, padding, the int32-max
    sentinel) gives ``(0, 0)``."""
    n = probe_slots.shape[0]
    table_size = table_start.shape[0]
    dev = probe_slots.device
    if table_size == 0:
        z = torch.zeros(n, dtype=torch.int32, device=dev)
        return z, z.clone()
    slots = probe_slots.long()
    ok = (slots >= 0) & (slots < table_size)
    idx = torch.where(ok, slots, 0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    starts = torch.where(ok, table_start[idx].to(torch.int32), zero)
    counts = torch.where(ok, table_count[idx].to(torch.int32), zero)
    return starts, counts


def masked_hash_probe_ref(table_start: torch.Tensor,
                          table_count: torch.Tensor,
                          probe_slots: torch.Tensor,
                          probe_mask: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hash_probe_ref` with a keep mask: a lane whose mask is
    false gives ``(0, 0)`` whatever its slot — the probe-side filter
    applied inside the lookup."""
    starts, counts = hash_probe_ref(table_start, table_count, probe_slots)
    keep = probe_mask.to(torch.bool)
    zero = torch.zeros((), dtype=torch.int32, device=starts.device)
    return torch.where(keep, starts, zero), torch.where(keep, counts, zero)
