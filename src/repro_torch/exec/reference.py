"""The row-loop reference backend — the differential-testing oracle.

This is the table layer's original interpreted implementation (its
NULL semantics), extracted verbatim from ``repro_torch.data.tables`` and extended
with ``how="left"``. It is deliberately naive: Python dicts of boxed
key tuples, per-row loops, first-appearance group ordering via dict
insertion. Its value is *semantic*, not performance — every other
backend must reproduce its output bit-for-bit (values, validity masks,
row order, and the typed fills in invalid lanes), which is what
``tests/test_exec_backends.py`` asserts.

Because keys are compared with Python dict/tuple equality, the oracle
pins down the edge semantics the vectorized backends must reproduce:
``NULL`` (mask or ``None`` payload) matches nothing in joins; NaN keys
match nothing (``NaN != NaN``); GROUP BY collapses all NULL keys into
one group while each NaN key stays its own group.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.exec.base import (AggSpec, Backend, Columns, _column_length,
                             fill_value, normalize_agg_specs,
                             payload_validity)

__all__ = ["ReferenceBackend"]

# Sentinel marking a NULL group key in group_by_agg: SQL GROUP BY puts
# all NULL keys in one group (unlike join equality, which matches none).
_NULL = object()


class ReferenceBackend(Backend):
    name = "reference"

    # -- join -----------------------------------------------------------
    def hash_join(self, left: Columns, right: Columns,
                  on: Sequence[str], how: str = "inner") -> Columns:
        # SQL semantics: NULL join keys match nothing (NULL = NULL is
        # not true). Inner: null-keyed rows are dropped from both sides;
        # left: null-keyed/unmatched left rows survive with NULL right
        # columns.
        lok = self._key_validity(left, on)
        rok = self._key_validity(right, on)
        lkeys = list(zip(*(left[k][0] for k in on)))
        rindex: dict[tuple, list[int]] = {}
        rkeys = list(zip(*(right[k][0] for k in on)))
        for i, k in enumerate(rkeys):
            if rok[i]:
                rindex.setdefault(k, []).append(i)
        li, ri = [], []
        for i, k in enumerate(lkeys):
            matches = rindex.get(k, ()) if lok[i] else ()
            if not matches:
                if how == "left":       # unmatched: keep, right = NULL
                    li.append(i)
                    ri.append(-1)
                continue
            for j in matches:
                li.append(i)
                ri.append(j)
        li_arr = np.array(li, dtype=int)
        ri_arr = np.array(ri, dtype=int)
        out: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        for n, (values, valid) in left.items():
            out[n] = (values[li_arr] if len(li_arr) else values[:0],
                      None if valid is None else valid[li_arr])
        matched = ri_arr >= 0
        safe = np.where(matched, ri_arr, 0)
        for n, (values, valid) in right.items():
            if n in out:                # join keys: keep left copy
                continue
            if how == "inner":
                out[n] = (values[ri_arr] if len(ri_arr) else values[:0],
                          None if valid is None else valid[ri_arr])
                continue
            if len(values):
                gathered = (values[safe] if len(safe) else values[:0])
                gathered[~matched] = fill_value(values.dtype)
                ok = (valid[safe] if valid is not None
                      else np.ones(len(safe), dtype=bool)) & matched
            else:                       # empty right side: all-NULL col
                gathered = np.full(len(safe), fill_value(values.dtype),
                                   dtype=values.dtype)
                ok = np.zeros(len(safe), dtype=bool)
            out[n] = (gathered, ok)
        return out

    @staticmethod
    def _key_validity(cols: Columns, on: Sequence[str]) -> np.ndarray:
        """Rows whose every join key is non-NULL (validity mask AND no
        ``None`` payload in object columns)."""
        ok = np.ones(_column_length(cols), dtype=bool)
        for k in on:
            values, valid = cols[k]
            ok &= payload_validity(values, valid)
        return ok

    # -- aggregation ----------------------------------------------------
    def group_by_agg(self, cols: Columns, keys: Sequence[str],
                     specs: Sequence[AggSpec]) -> Columns:
        # SQL aggregate semantics over nullable columns: SUM/MIN/MAX/
        # MEAN skip NULL values (an all-NULL group aggregates to NULL),
        # COUNT counts non-NULL values and is never NULL, and NULL keys
        # form their own single group. Two row loops: one assigns group
        # slots in first-appearance (dict-insertion) order, then each
        # spec accumulates in row order — the same order the original
        # single-pass group_by_sum used, so SUM results are bit-for-bit
        # unchanged.
        specs = normalize_agg_specs(cols, keys, specs)
        n = _column_length(cols)
        kcols = [cols[k][0] for k in keys]
        kvalid = [self._validity(cols[k]) for k in keys]
        groups: dict[tuple, int] = {}
        order: list[tuple] = []
        gid = np.empty(n, dtype=np.int64)
        for i in range(n):
            k = tuple(c[i] if kvalid[j][i] and c[i] is not None else _NULL
                      for j, c in enumerate(kcols))
            slot = groups.get(k)
            if slot is None:
                slot = len(order)
                groups[k] = slot
                order.append(k)
            gid[i] = slot
        data: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        for j, kname in enumerate(keys):
            dt = kcols[j].dtype
            fill = fill_value(dt)
            colvals = np.array([fill if k[j] is _NULL else k[j]
                                for k in order], dtype=dt)
            mask = np.array([k[j] is not _NULL for k in order], dtype=bool)
            data[kname] = (colvals, mask)
        for fn, value, out in specs:
            data[out] = self._agg_one(fn, cols[value], gid, len(order))
        return data

    @staticmethod
    def _agg_one(fn: str, col: tuple[np.ndarray, "np.ndarray | None"],
                 gid: np.ndarray, n_groups: int
                 ) -> tuple[np.ndarray, np.ndarray | None]:
        vals, valid = col
        ok = payload_validity(vals, valid)
        counts = np.zeros(n_groups, dtype=np.int64)
        acc: list[Any] = [None] * n_groups
        is_object = vals.dtype == object
        for i in range(len(vals)):
            if not ok[i]:
                continue
            g = int(gid[i])
            counts[g] += 1
            v = vals[i]
            a = acc[g]
            if a is None:
                acc[g] = v
            elif fn in ("sum", "mean"):
                acc[g] = a + v
            elif fn == "min":
                # object: Python compare (ties keep the accumulator);
                # numeric: np.minimum, which propagates NaN values.
                acc[g] = (v if v < a else a) if is_object else np.minimum(a, v)
            elif fn == "max":
                acc[g] = (v if v > a else a) if is_object else np.maximum(a, v)
        if fn == "count":
            return counts, None         # COUNT is int64 and never NULL
        if fn == "mean":
            if is_object:
                vdt = np.dtype(object)
                res = [None if a is None else a / c
                       for a, c in zip(acc, counts)]
            else:
                # MEAN is always SUM/COUNT finalized in float64 — the
                # shippable-partials definition every backend shares
                # (and the float summation-order carve-out extends to it).
                vdt = np.dtype(np.float64)
                res = [None if a is None else np.float64(a) / c
                       for a, c in zip(acc, counts)]
            fill = fill_value(vdt)
            return (np.array([fill if a is None else a for a in res],
                             dtype=vdt),
                    np.array([a is not None for a in res], dtype=bool))
        vdt = vals.dtype
        fill = fill_value(vdt)
        return (np.array([fill if a is None else a for a in acc],
                         dtype=vdt),
                np.array([a is not None for a in acc], dtype=bool))

    @staticmethod
    def _validity(col: tuple[np.ndarray, "np.ndarray | None"]) -> np.ndarray:
        values, valid = col
        return (valid if valid is not None
                else np.ones(len(values), dtype=bool))
