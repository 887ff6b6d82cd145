"""Execution-backend interface for the columnar table layer (DESIGN.md §9).

A backend implements the four physical operators the relational layer
dispatches (:class:`~repro_torch.data.tables.Table` stays the only public
API): ``hash_join``, ``group_by_agg``, ``filter_select`` and ``concat``.
Backends operate on *column dicts* — ``{name: (values, valid)}`` with
numpy value arrays and optional boolean validity masks — rather than on
:class:`Table` itself, so the package has no import cycle with the
table layer and a backend can be exercised (and differentially tested)
without building tables.

Semantics are fixed by the ``reference`` backend (the extracted
row-loop implementation): every registered backend must agree with it
bit-for-bit — including NULL handling, row order, and the typed fill
payloads it writes into invalid lanes (fills are hashed by
``Table.fingerprint``, so "don't care" lanes still have to match).
One documented carve-out: *float* SUM and MEAN results are
deterministic per backend but exact only up to summation order across
backends (SIMD / device reductions regroup additions, and MEAN is
finalized from a float sum; no engine promises bit-stable float
aggregation across execution strategies). Integer sums have no
carve-out — integer addition is associative even under wraparound —
and MIN/MAX/COUNT have none either (order-independent reductions).
``tests/test_exec_backends.py`` enforces all of this differentially.

Shared NULL conventions (SQL semantics):

- join keys: a NULL key matches nothing (``NULL = NULL`` is not TRUE);
  NaN/NaT keys also match nothing (Python/numpy equality agrees);
- GROUP BY keys: all NULL keys form ONE group; NaN keys are pairwise
  distinct (NaN != NaN), so each NaN-keyed row is its own group;
- SUM/MIN/MAX/MEAN skip NULL values; a group whose values are all NULL
  aggregates to NULL. COUNT counts non-NULL values and is never NULL
  (an all-NULL group counts 0). A NaN *value* (valid lane) propagates
  through MIN/MAX (numpy ``minimum``/``maximum`` semantics).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

__all__ = ["Columns", "Backend", "fill_value", "payload_validity",
           "AGG_FNS", "AggSpec", "normalize_agg_specs"]

# {column name: (values, validity-or-None)} — insertion order is column
# order. `valid is None` means "no NULLs" (the Table-layer convention).
Columns = Mapping[str, tuple[np.ndarray, "np.ndarray | None"]]


def fill_value(dtype: np.dtype):
    """The canonical payload written into invalid (NULL) lanes: ``None``
    for object columns, the dtype's zero otherwise. Every backend must
    use the same fill so snapshots/fingerprints do not depend on which
    backend produced a table."""
    return None if dtype == object else np.zeros(1, dtype=dtype)[0]


def payload_validity(values: np.ndarray,
                     valid: np.ndarray | None) -> np.ndarray:
    """Effective validity of a column: the mask AND, for object columns,
    "payload is not None" (freshly-built object columns may carry None
    payloads before any mask exists)."""
    n = len(values)
    ok = (valid.astype(bool, copy=True) if valid is not None
          else np.ones(n, dtype=bool))
    if values.dtype == object:
        ok &= np.array([v is not None for v in values], dtype=bool)
    return ok


def _column_length(cols: Columns) -> int:
    for values, _ in cols.values():
        return len(values)
    return 0


# The aggregate vocabulary every backend must implement. MEAN is always
# finalized from SUM and COUNT (float64 for numeric values) so the
# sharded backend can ship partials; COUNT is COUNT(value) — non-NULL
# lanes — int64 and never NULL.
AGG_FNS = ("sum", "count", "min", "max", "mean")

# One aggregate: (fn, value column, output column).
AggSpec = tuple[str, str, str]


def normalize_agg_specs(cols: Columns, keys: Sequence[str],
                        specs: Sequence[AggSpec]) -> tuple[AggSpec, ...]:
    """Validate one ``group_by_agg`` call (shared by every backend).

    Checks fn vocabulary, value-column existence, and output-name
    collisions (against the group keys and between specs). Returns the
    specs as a plain tuple so backends can hash/iterate it freely."""
    out: list[AggSpec] = []
    seen: set[str] = set(keys)
    for spec in specs:
        fn, value, name = spec
        if fn not in AGG_FNS:
            raise ValueError(
                f"unknown aggregate fn {fn!r} (expected one of {AGG_FNS})")
        if value not in cols:
            raise KeyError(f"unknown aggregate value column: {value!r}")
        if name in seen:
            raise ValueError(
                f"aggregate output column {name!r} collides with a "
                f"group key or another aggregate output")
        seen.add(name)
        out.append((fn, value, name))
    if not out:
        raise ValueError("group_by_agg requires at least one spec")
    return tuple(out)


class Backend:
    """One physical implementation of the relational operators.

    Subclasses set ``name`` and implement ``hash_join`` and
    ``group_by_agg``; ``filter_select`` and ``concat`` have shared
    default implementations (plain gather/concatenate — already
    vectorized, and semantics-free enough that the differential suite
    keeps everyone honest)."""

    name: str = "?"

    def cache_token(self) -> str:
        """What the engine folds into node cache keys (DESIGN.md §9/§10).

        The name alone for host backends; backends whose execution
        depends on ambient machine state (device mesh shape, shard
        count, auto-selection policy) must extend it so that state
        change moves every key — a cache hit must never survive a
        regrouping that the float-SUM summation-order carve-out makes
        observable."""
        return self.name

    # -- joins ----------------------------------------------------------
    def hash_join(self, left: Columns, right: Columns,
                  on: Sequence[str], how: str = "inner") -> Columns:
        raise NotImplementedError

    def masked_hash_join(self, left: Columns, right: Columns,
                         on: Sequence[str], how: str = "inner", *,
                         left_mask: "np.ndarray | None" = None,
                         right_mask: "np.ndarray | None" = None
                         ) -> Columns:
        """Filter-fused join. SEMANTICS (normative, what every override
        must reproduce bit for bit): filter each masked side with
        ``filter_select``, then ``hash_join`` the survivors. This
        default IS that definition — the reference backend inherits it
        unchanged, so the differential suite pins the fused paths
        (vectorized key-validity ANDing, the sharded backend's in-VMEM
        Pallas mask) to materialized filtering.

        Equivalence fine print: a fused implementation may produce an
        all-True validity array where this default produces ``None``
        (or vice versa) — the Table layer's ``_ColumnData`` normalizes
        all-True masks to ``None``, so the two are one representation
        by the time anything observable (fingerprint, snapshot) sees
        them. Masks are plain boolean keep-masks over the *unfiltered*
        inputs; ``None`` means keep everything.
        """
        if left_mask is not None:
            left = self.filter_select(left, left_mask)
        if right_mask is not None:
            right = self.filter_select(right, right_mask)
        return self.hash_join(left, right, on, how)

    # -- aggregation ----------------------------------------------------
    def group_by_agg(self, cols: Columns, keys: Sequence[str],
                     specs: Sequence[AggSpec]) -> Columns:
        """Multi-function GROUP BY: one output row per distinct key
        tuple (first-appearance order, the reference backend's dict
        order), key columns first, then one column per ``(fn, value,
        out)`` spec. NULL semantics per the module docstring."""
        raise NotImplementedError

    def group_by_sum(self, cols: Columns, keys: Sequence[str],
                     value: str, out: str) -> Columns:
        """Back-compat single-SUM entry point — now a thin delegation
        to ``group_by_agg`` (pinned byte-identical to the pre-refactor
        path by the regression suite)."""
        return self.group_by_agg(cols, keys, (("sum", value, out),))

    # -- row selection --------------------------------------------------
    def filter_select(self, cols: Columns, mask: np.ndarray) -> Columns:
        mask = np.asarray(mask, dtype=bool)
        return {
            name: (values[mask],
                   None if valid is None else valid[mask])
            for name, (values, valid) in cols.items()}

    # -- concatenation --------------------------------------------------
    def concat(self, a: Columns, b: Columns) -> Columns:
        if set(a) != set(b):
            raise ValueError("column sets differ")
        out: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        for name, (av, avalid) in a.items():
            bv, bvalid = b[name]
            values = np.concatenate([av, bv])
            if avalid is None and bvalid is None:
                valid = None
            else:
                la = (avalid if avalid is not None
                      else np.ones(len(av), dtype=bool))
                rb = (bvalid if bvalid is not None
                      else np.ones(len(bv), dtype=bool))
                valid = np.concatenate([la, rb])
            out[name] = (values, valid)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"
