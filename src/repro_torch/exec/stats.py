"""Per-table statistics that drive backend auto-selection.

Two producers, one consumer:

- ``planner.plan(pipeline, table_stats=...)`` records source-table
  stats in :class:`~repro_torch.core.planner.PlanStep` metadata at the
  control-plane moment, so a plan describes not just *what* each node
  computes but roughly *how much* — observability for the scheduler
  and for humans reading ``plan.describe()``.
- :class:`~repro_torch.exec.auto.AutoBackend` re-derives the same stats per
  dispatch from the live column dicts (``collect_stats`` is O(sample),
  never O(n·log n)) — the decision point sees exact row counts even
  for intermediate tables whose size the planner could not know.

The statistics are deliberately coarse: row count, key dtype kinds,
an estimated key cardinality from a strided sample, and — for single
integer keys — the value span that decides whether a direct-address
(bincount) probe table is affordable. They feed a *threshold* decision
table (exec/auto.py), so estimate error of 2× is harmless.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.exec.base import (Columns, _column_length, comparison_form,
                                   payload_validity)

__all__ = ["TableStats", "collect_stats"]

_SAMPLE = 4096


@dataclasses.dataclass(frozen=True)
class TableStats:
    """Cheap summary of one table, keyed for a specific operation."""

    n_rows: int
    key_kinds: tuple[str, ...] = ()     # numpy dtype kinds, per key col
    est_key_cardinality: int | None = None
    int_key_span: int | None = None     # max-min+1, single int key only
    # key value bounds (single int key): lets a consumer compute the
    # exact JOINT span of two tables — per-side spans alone
    # underestimate without bound when the sides' key ranges are
    # disjoint.
    int_key_lo: int | None = None
    int_key_hi: int | None = None

    @property
    def single_int_key(self) -> bool:
        return len(self.key_kinds) == 1 and self.key_kinds[0] in "iu"

    def describe(self) -> str:
        bits = [f"rows={self.n_rows}"]
        if self.key_kinds:
            bits.append(f"keys={','.join(self.key_kinds)}")
        if self.est_key_cardinality is not None:
            bits.append(f"card~{self.est_key_cardinality}")
        if self.int_key_span is not None:
            bits.append(f"span={self.int_key_span}")
        return " ".join(bits)


def _estimate_cardinality(values: np.ndarray, ok: np.ndarray) -> int:
    """Distinct-count estimate from a strided sample: exact for small
    tables, a linear scale-up of sample distinctness for large ones
    (saturating — a saturated sample reads as 'all distinct')."""
    n = len(values)
    if n == 0:
        return 0
    if n <= _SAMPLE:
        idx = np.flatnonzero(ok)
    else:
        stride = max(1, n // _SAMPLE)
        idx = np.arange(0, n, stride)
        idx = idx[ok[idx]]
    if len(idx) == 0:
        return 0
    # a bfloat16 key counts as its float32 form (±0.0 one value, NaNs
    # one, as for a float32 key), not by its bits
    sample = comparison_form(values)[idx]
    if values.dtype == object:
        distinct = len({v for v in sample})
    else:
        distinct = len(np.unique(sample))
    if n <= _SAMPLE or distinct < max(1, len(idx) // 2):
        return distinct
    # sample nearly all-distinct: assume cardinality scales with n
    return max(distinct, int(distinct * (n / max(1, len(idx)))))


def collect_stats(cols: Columns, keys: Sequence[str] = (), *,
                  estimate_cardinality: bool = True) -> TableStats:
    """``estimate_cardinality=False`` skips the sampling pass and
    leaves ``est_key_cardinality`` None — the auto policy's decision
    table reads only rows/kinds/span, so its per-dispatch collection
    pays nothing it does not use; plan-time metadata keeps the
    estimate for observability."""
    n = _column_length(cols)
    kinds: list[str] = []
    card: int | None = None
    span: int | None = None
    lo: int | None = None
    hi: int | None = None
    for k in keys:
        values, valid = cols[k]
        kinds.append("O" if values.dtype == object else values.dtype.kind)
    if len(keys) == 1:
        values, valid = cols[keys[0]]
        ok = payload_validity(values, valid)
        if estimate_cardinality:
            card = _estimate_cardinality(values, ok)
        if values.dtype != object and values.dtype.kind in "iu" \
                and ok.any():
            vv = values[ok] if not ok.all() else values
            lo, hi = int(vv.min()), int(vv.max())
            span = hi - lo + 1
    elif keys and estimate_cardinality:
        cards = []
        for k in keys:
            values, valid = cols[k]
            cards.append(_estimate_cardinality(
                values, payload_validity(values, valid)))
        # joint cardinality is at most the product, at most n
        prod = 1
        for c in cards:
            prod = min(prod * max(c, 1), n if n else 1)
        card = prod
    return TableStats(n_rows=n, key_kinds=tuple(kinds),
                      est_key_cardinality=card, int_key_span=span,
                      int_key_lo=lo, int_key_hi=hi)
