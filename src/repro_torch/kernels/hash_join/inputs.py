"""The probe inputs that ``chip_smoke.py`` checks and times and
``examples/probe_tune.py`` tunes on: a direct-address table as the
partitioned join builds it from TPC-H SF1's order keys, and probe lanes
into it. Made on ``device`` from the generator ``g``, so the same seed
gives the same draws in both scripts.
"""
from __future__ import annotations

import torch

__all__ = ["PROBE_SLOTS", "ORDERS", "INT32_MAX", "probe_inputs"]

PROBE_SLOTS = 1 << 23           # the SF1 orderkey span, to a power of two
ORDERS = 1_500_000              # orders at SF1: the table's build keys
INT32_MAX = 2**31 - 1           # the partitioned join's sentinel


def probe_inputs(n: int, order: str, g: torch.Generator, *,
                 slots: int = PROBE_SLOTS, keys: int = ORDERS,
                 device: str = "cuda"):
    """A table of ``slots`` slots from ``keys`` build keys (a tenth of
    them repeated, so some slots hold duplicates and most stay empty),
    and n probe lanes: hits (ascending when ``order`` is "clustered", as
    l_orderkey probes orders; shuffled when "random"), 10% on random
    slots (mostly empty), 1% each negative, >= T and the int32 sentinel;
    a mask keeping half the lanes. Returns (table_start, table_count,
    probe_slots, probe_mask)."""
    t, m = slots, keys
    build = torch.randint(0, t, (m,), generator=g, device=device,
                          dtype=torch.int32)
    dup = torch.rand(m, generator=g, device=device) < 0.1
    build[dup] = build.roll(1)[dup]
    counts = torch.bincount(build.long(), minlength=t).to(torch.int32)
    srt, _ = torch.sort(build)
    starts = torch.full((t,), m, dtype=torch.int32, device=device)
    starts.scatter_reduce_(0, srt.long(),
                           torch.arange(m, dtype=torch.int32, device=device),
                           reduce="amin")
    pick = torch.randint(0, m, (n,), generator=g, device=device)
    if order == "clustered":
        pick, _ = torch.sort(pick)
    lanes = srt[pick]
    r = torch.rand(n, generator=g, device=device)
    spots = torch.randint(0, t, (n,), generator=g, device=device,
                          dtype=torch.int32)
    lanes = torch.where(r < 0.10, spots, lanes)
    lanes = torch.where((r >= 0.10) & (r < 0.11), -1 - spots, lanes)
    lanes = torch.where((r >= 0.11) & (r < 0.12), t + spots, lanes)
    lanes = torch.where((r >= 0.12) & (r < 0.13),
                        torch.full_like(lanes, INT32_MAX), lanes)
    mask = torch.rand(n, generator=g, device=device) < 0.5
    return starts, counts, lanes.contiguous(), mask
