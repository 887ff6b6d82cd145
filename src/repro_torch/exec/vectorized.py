"""Vectorized numpy backend — the default execution backend.

Replaces the interpreted row loops of the ``reference`` oracle with
factorize/sort-based kernels while reproducing its output bit-for-bit
(row order, validity masks, NULL fills, float accumulation order):

- **hash_join**: per-key factorization to dense int64 codes (shared
  dictionary across both sides so codes align), stable sort of the
  right side, ``searchsorted`` range lookup per left row, and a
  vectorized ragged-range expansion. Stable sorting preserves right-
  occurrence order within a key, and left rows are expanded in order —
  exactly the reference's (left row, right occurrence) nesting.
- **group_by_agg**: joint key factorization, group ids renumbered to
  first-appearance order, then one ``ufunc.reduceat`` per aggregate
  spec over the same stably sorted valid lanes (``np.add`` for
  SUM/COUNT, ``np.minimum``/``np.maximum`` for MIN/MAX with invalid
  lanes parked at the identity; MEAN finalized as float64 SUM/COUNT).
  Integer sums are bit-identical to the reference (integer addition is
  associative, wraparound included); float sums — and the means
  finalized from them — are deterministic but exact only up to
  summation order: ``reduceat``'s SIMD partial sums regroup additions,
  which can move the last ulp (the one documented carve-out from the
  bit-for-bit contract, see base.py). MIN/MAX/COUNT have no carve-out.

NULL/NaN conventions (see base.py): join keys that are NULL, NaN, or
NaT get code -1 (match nothing); GROUP BY gives all NULL keys one
shared code and every NaN key its own fresh code. Object columns are
factorized through a Python dict, which *inherits* the reference's
identity-or-equality semantics (e.g. the same ``nan`` object is one
key, two distinct ``nan`` objects are two).

Object-dtype *value* columns cannot be summed by numpy ufuncs; the
aggregation falls back to the reference row loop for exactly that
column kind (group structure stays vectorized).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.exec.base import (AggSpec, Backend, Columns, _column_length,
                             fill_value, normalize_agg_specs,
                             payload_validity)

__all__ = ["VectorizedBackend", "dense_span_affordable", "reduce_ident"]


def reduce_ident(dtype: np.dtype, op: str):
    """Identity element for masked MIN/MAX over ``dtype``: invalid
    lanes are parked here so they can never win the reduction."""
    if dtype.kind == "f":
        return dtype.type(np.inf if op == "min" else -np.inf)
    if dtype.kind == "b":
        return np.bool_(op == "min")
    info = np.iinfo(dtype)
    return dtype.type(info.max if op == "min" else info.min)


def dense_span_affordable(span: int, n_rows: int) -> bool:
    """Is a direct-address table over ``span`` key slots worth it for
    ``n_rows`` total rows? The single source of truth for the
    bincount fast path below AND for the ``auto`` policy's
    dense-int-key row (exec/auto.py) — tune it in one place."""
    return span <= 4 * n_rows + 1024


# ---------------------------------------------------------------------------
# key factorization
# ---------------------------------------------------------------------------

def _factorize_object(values: np.ndarray, ok: np.ndarray,
                      codes: np.ndarray, table: dict) -> int:
    """Dict-factorize an object column's valid lanes into ``codes``
    (invalid lanes stay -1). Python dict lookup is identity-or-equality,
    matching the reference's tuple-key dict exactly."""
    get = table.get
    for i, v in enumerate(values):
        if not ok[i]:
            continue
        c = get(v, -1)
        if c < 0:
            c = len(table)
            table[v] = c
        codes[i] = c
    return len(table)


def _unmatchable(values: np.ndarray) -> np.ndarray | None:
    """Lanes whose payload can never compare equal to anything (NaN /
    NaT) — non-object dtypes only."""
    if values.dtype.kind in "fc":
        return np.isnan(values)
    if values.dtype.kind in "mM":
        return np.isnat(values)
    return None


def _join_codes(left: Columns, right: Columns,
                on: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """Dense join codes for both sides (aligned); -1 = can match nothing
    (NULL / None payload / NaN / NaT key component)."""
    n_left = _column_length(left)
    combined: np.ndarray | None = None
    for k in on:
        lv, lval = left[k]
        rv, rval = right[k]
        ok = np.concatenate([payload_validity(lv, lval),
                             payload_validity(rv, rval)])
        if (lv.dtype == object or rv.dtype == object
                or lv.dtype.kind != rv.dtype.kind):
            # object columns, and cross-kind keys (int64 vs float64,
            # int vs uint64): dict-factorize boxed payloads so matching
            # is exact Python equality — np.concatenate would promote
            # mixed kinds to float64 and silently collapse 2**53 with
            # 2**53+1.
            values = np.concatenate([
                lv if lv.dtype == object else lv.astype(object),
                rv if rv.dtype == object else rv.astype(object)])
            codes = np.full(len(values), -1, dtype=np.int64)
            _factorize_object(values, ok, codes, {})
        else:
            values = np.concatenate([lv, rv])
            bad = _unmatchable(values)
            if bad is not None:
                ok = ok & ~bad
            codes = np.full(len(values), -1, dtype=np.int64)
            if ok.any():
                _, inv = np.unique(values[ok], return_inverse=True)
                codes[ok] = inv
        combined = codes if combined is None else _merge_codes(
            combined, codes)
    assert combined is not None, "join requires at least one key"
    return combined[:n_left], combined[n_left:]


def _merge_codes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Combine two per-column code arrays into joint codes, compacting
    with np.unique at every step so the intermediate product never
    overflows int64. -1 (unmatchable) in either column poisons the row."""
    ok = (a >= 0) & (b >= 0)
    out = np.full(len(a), -1, dtype=np.int64)
    if ok.any():
        merged = a[ok] * (int(b.max()) + 1) + b[ok]
        _, inv = np.unique(merged, return_inverse=True)
        out[ok] = inv
    return out


def _group_codes(cols: Columns, keys: Sequence[str]) -> np.ndarray:
    """Dense GROUP BY codes (all lanes >= 0): NULL key components share
    ONE code per column; NaN/NaT components each get a fresh code (the
    reference's dict-of-boxed-scalars gives every NaN its own group)."""
    n = _column_length(cols)
    if not keys:
        return np.zeros(n, dtype=np.int64)
    combined: np.ndarray | None = None
    for k in keys:
        values, valid = cols[k]
        ok = payload_validity(values, valid)
        codes = np.full(n, -1, dtype=np.int64)
        if values.dtype == object:
            # dict factorization already keeps distinct NaN objects
            # distinct (hash collides, equality fails -> separate keys)
            card = _factorize_object(values, ok, codes, {})
        else:
            bad = _unmatchable(values)
            distinct = ok & bad if bad is not None else np.zeros(n, bool)
            plain = ok & ~distinct
            card = 0
            if plain.any():
                _, inv = np.unique(values[plain], return_inverse=True)
                codes[plain] = inv
                card = int(inv.max()) + 1
            if distinct.any():        # one fresh code per NaN/NaT lane
                m = int(distinct.sum())
                codes[distinct] = card + np.arange(m)
                card += m
        codes[codes < 0] = card       # the single NULL group
        combined = codes if combined is None else _merge_group_codes(
            combined, codes)
    return combined


def _merge_group_codes(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if not len(a):
        return a
    merged = a * (int(b.max()) + 1) + b
    _, inv = np.unique(merged, return_inverse=True)
    return inv.reshape(-1).astype(np.int64, copy=False)


def _group_runs(codes: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One stable sort of ``codes`` -> (order, bounds, grp_order, rep).

    ``order`` sorts rows into group runs; ``bounds`` marks run starts in
    sorted-row space; ``grp_order`` permutes code-ordered groups into
    first-appearance order (the reference's dict-insertion order) and
    ``rep`` is each group's first row index, in output order."""
    if not len(codes):                  # zero rows -> zero groups
        empty = np.array([], dtype=np.int64)
        return empty, empty, empty, empty
    order = np.argsort(codes, kind="stable")
    cs = codes[order]
    bounds = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
    first_rows = order[bounds]      # stable sort: earliest row per run
    grp_order = np.argsort(first_rows, kind="stable")
    return order, bounds, grp_order, first_rows[grp_order]


def _and_key_validity(cols: Columns, on: Sequence[str],
                      mask: np.ndarray) -> Columns:
    """AND a keep-mask into the *key columns'* validity (shallow copy).

    Masked-out rows then look NULL-keyed to the probe, so inner-join
    emission drops them without a filter pass. Sound only because
    ``_gather_right`` never copies a key column that the left side
    already produced — the poisoned key validity never reaches the
    output (left keys: every emitted inner lane has mask True, so the
    AND is a no-op on survivors)."""
    out = dict(cols)
    keep = np.asarray(mask, dtype=bool)
    for k in on:
        values, valid = out[k]
        valid = keep if valid is None else (valid & keep)
        out[k] = (values, valid)
    return out


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

class VectorizedBackend(Backend):
    name = "vectorized"

    # -- join -----------------------------------------------------------
    def hash_join(self, left: Columns, right: Columns,
                  on: Sequence[str], how: str = "inner") -> Columns:
        fast = self._single_key_probe(left, right, on)
        if fast is not None:
            n_left, starts, counts, ridx = fast
        else:
            lcodes, rcodes = _join_codes(left, right, on)
            n_left = len(lcodes)
            rvalid = np.flatnonzero(rcodes >= 0)
            order = np.argsort(rcodes[rvalid], kind="stable")
            rsorted = rcodes[rvalid][order]
            ridx = rvalid[order]        # right rows, sorted by code,
            #                             occurrence order within a code
            starts = np.searchsorted(rsorted, lcodes, side="left")
            ends = np.searchsorted(rsorted, lcodes, side="right")
            counts = np.where(lcodes >= 0, ends - starts, 0)
        return self._emit_join(left, right, how, n_left, starts, counts,
                               ridx)

    def masked_hash_join(self, left: Columns, right: Columns,
                         on: Sequence[str], how: str = "inner", *,
                         left_mask: np.ndarray | None = None,
                         right_mask: np.ndarray | None = None
                         ) -> Columns:
        """Fused filtering: AND the keep-masks into the key columns'
        validity and run the normal probe — a masked row looks
        NULL-keyed, matches nothing, and (for inner joins) is never
        emitted. No intermediate filtered table is materialized.

        The one case that MUST prefilter: ``how='left'`` with a
        ``left_mask`` — a NULL-keyed left row still emits (once, with
        NULL right columns) under left-join semantics, but a
        filtered-out row must not emit at all. Right masks are safe for
        both hows (masked right rows simply stop matching), and
        ``_gather_right`` skips key columns the left side already
        produced, so the poisoned right key validity never surfaces.
        """
        if left_mask is not None and how != "inner":
            left = self.filter_select(left, left_mask)
            left_mask = None
        if left_mask is not None:
            left = _and_key_validity(left, on, left_mask)
        if right_mask is not None:
            right = _and_key_validity(right, on, right_mask)
        return self.hash_join(left, right, on, how)

    def _emit_join(self, left: Columns, right: Columns, how: str,
                   n_left: int, starts: np.ndarray, counts: np.ndarray,
                   ridx: np.ndarray) -> Columns:
        """Ragged-match emission shared by every probe strategy.

        ``ridx`` lists right rows grouped by key (matches for a key are
        contiguous, in right-occurrence order); left row ``i``'s matches
        are ``ridx[starts[i] : starts[i] + counts[i]]``. The grouped
        layout need not be globally key-sorted — the sharded backend
        concatenates per-shard runs — only per-key contiguous.
        """
        unique_match = int(counts.max()) <= 1 if len(counts) else True
        if how == "inner":
            if unique_match:
                # FK-join shape (every left row matches <= 1 right row):
                # the ragged expansion collapses to two gathers.
                li = np.flatnonzero(counts)
                ri = ridx[starts[li]]
            else:
                total = int(counts.sum())
                li = np.repeat(np.arange(n_left), counts)
                run_starts = np.cumsum(counts) - counts
                # pos[j] = starts[row] + (j - run_start[row]): fold both
                # per-row terms into ONE ragged repeat.
                pos = (np.arange(total)
                       + np.repeat(starts - run_starts, counts))
                ri = ridx[pos]
        else:                           # left: unmatched rows emit once
            if unique_match:
                li = np.arange(n_left)
                if len(ridx):
                    safe = np.minimum(starts, len(ridx) - 1)
                    ri = np.where(counts > 0, ridx[safe], -1)
                else:
                    ri = np.full(n_left, -1, dtype=np.int64)
            else:
                counts_out = np.maximum(counts, 1)
                total = int(counts_out.sum())
                li = np.repeat(np.arange(n_left), counts_out)
                run_starts = np.cumsum(counts_out) - counts_out
                has = np.repeat(counts > 0, counts_out)
                pos = (np.arange(total)
                       + np.repeat(np.where(counts > 0, starts, 0)
                                   - run_starts, counts_out))
                if len(ridx):
                    ri = np.where(has, ridx[np.where(has, pos, 0)], -1)
                else:
                    ri = np.full(total, -1, dtype=np.int64)

        out: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        for n, (values, valid) in left.items():
            out[n] = (values[li], None if valid is None else valid[li])
        return self._gather_right(out, right, how, li, ri)

    @staticmethod
    def _single_key_probe(left: Columns, right: Columns,
                          on: Sequence[str]):
        """Single non-object key: probe raw values — no factorization
        pass. Returns (n_left, starts, counts, ridx) where ``ridx``
        lists valid right rows stably sorted by key and, per left row,
        its matches are ``ridx[starts : starts + counts]``.

        Two levels: dense *integer* keys probe a direct-address
        bincount table (no binary search at all — the classic
        radix-partition trick, and the common FK-join shape); anything
        else binary-searches the sorted right keys. Either way matching
        is numpy equality, which coincides with the reference's Python
        equality for every non-object dtype (NaN/NaT = unmatchable)."""
        if len(on) != 1:
            return None
        lv, lval = left[on[0]]
        rv, rval = right[on[0]]
        if lv.dtype == object or rv.dtype == object:
            return None
        if lv.dtype.kind != rv.dtype.kind:
            # cross-kind equality (int vs float keys) is defined by
            # Python numeric comparison; leave it to the codes path.
            return None
        lok = payload_validity(lv, lval)
        rok = payload_validity(rv, rval)
        for values, ok in ((lv, lok), (rv, rok)):
            bad = _unmatchable(values)
            if bad is not None:
                ok &= ~bad
        n_left = len(lv)
        rvalid = (np.arange(len(rv)) if rok.all()
                  else np.flatnonzero(rok))
        rvv = rv if len(rvalid) == len(rv) else rv[rvalid]

        if lv.dtype.kind in "iu" and len(rvv) and lok.any():
            lvv = lv if lok.all() else lv[lok]
            mn = min(int(lvv.min()), int(rvv.min()))
            mx = max(int(lvv.max()), int(rvv.max()))
            span = mx - mn + 1
            if (dense_span_affordable(span, n_left + len(rvv))
                    and -2**62 < mn and mx < 2**62):  # int64-safe math
                # direct-address probe: per-key counts/offsets into the
                # key-sorted ridx, then O(1) gathers per left row. The
                # rebased int32 keys also make the stable argsort a
                # 4-pass radix sort.
                key_r = (rvv - mn).astype(np.int32)
                order = np.argsort(key_r, kind="stable")
                ridx = rvalid[order]
                counts_k = np.bincount(key_r, minlength=span)
                offsets = np.concatenate(
                    [np.zeros(1, np.int64), np.cumsum(counts_k)])
                kl = np.clip(lv, mn, mx).astype(np.int64) - mn
                starts = offsets[kl]
                counts = np.where(lok, counts_k[kl], 0)
                return n_left, starts, counts, ridx

        order = np.argsort(rvv, kind="stable")
        ridx = rvalid[order]
        rsorted = rvv[order]
        starts = np.searchsorted(rsorted, lv, side="left")
        ends = np.searchsorted(rsorted, lv, side="right")
        counts = np.where(lok, ends - starts, 0)
        return n_left, starts, counts, ridx

    def _gather_right(self, out: dict, right: Columns, how: str,
                      li: np.ndarray, ri: np.ndarray) -> Columns:
        matched = ri >= 0
        safe = np.where(matched, ri, 0)
        for n, (values, valid) in right.items():
            if n in out:                # join keys: keep left copy
                continue
            if how == "inner":
                out[n] = (values[ri],
                          None if valid is None else valid[ri])
                continue
            if len(values):
                gathered = values[safe]
                gathered[~matched] = fill_value(values.dtype)
                ok = (valid[safe] if valid is not None
                      else np.ones(len(safe), dtype=bool)) & matched
            else:                       # empty right side: all-NULL col
                gathered = np.full(len(safe), fill_value(values.dtype),
                                   dtype=values.dtype)
                ok = np.zeros(len(safe), dtype=bool)
            out[n] = (gathered, ok)
        return out

    # -- aggregation ----------------------------------------------------
    def group_by_agg(self, cols: Columns, keys: Sequence[str],
                     specs: Sequence[AggSpec]) -> Columns:
        specs = normalize_agg_specs(cols, keys, specs)
        order, bounds, grp_order, rep = self._runs_for_keys(cols, keys)
        n_groups = len(rep)
        data: dict[str, tuple[np.ndarray, np.ndarray | None]] = {}
        for kname in keys:
            values, valid = cols[kname]
            ok = payload_validity(values, valid)
            colvals = values[rep]
            mask = ok[rep]
            colvals[~mask] = fill_value(values.dtype)
            data[kname] = (colvals, mask)
        for fn, value, out in specs:
            values, valid = cols[value]
            ok = payload_validity(values, valid)
            data[out] = self._agg_one(fn, values, ok, order, bounds,
                                      grp_order, n_groups)
        return data

    @staticmethod
    def _runs_for_keys(cols: Columns, keys: Sequence[str]):
        # single never-NULL integer-kind key: runs of sorted raw values
        # ARE the groups — skip the whole factorization pass.
        if len(keys) == 1:
            kv, kvalid = cols[keys[0]]
            if (kv.dtype != object and kv.dtype.kind in "iub"
                    and kvalid is None):
                return _group_runs(kv)
        return _group_runs(_group_codes(cols, keys))

    def _agg_one(self, fn: str, values: np.ndarray, ok: np.ndarray,
                 order: np.ndarray, bounds: np.ndarray,
                 grp_order: np.ndarray, n_groups: int
                 ) -> tuple[np.ndarray, np.ndarray | None]:
        """One aggregate column over precomputed group runs (runs are
        shared across every spec in a group_by_agg call)."""
        if fn == "sum":
            return self._aggregate(values, ok, order, bounds, grp_order,
                                   n_groups)
        if fn == "count":
            if n_groups == 0:
                return np.array([], dtype=np.int64), None
            counts = np.add.reduceat(
                ok[order].astype(np.int64), bounds)[grp_order]
            return counts, None         # COUNT is int64 and never NULL
        if fn == "mean":
            return self._agg_mean(values, ok, order, bounds, grp_order,
                                  n_groups)
        return self._agg_minmax(fn, values, ok, order, bounds,
                                grp_order, n_groups)

    def _agg_mean(self, values, ok, order, bounds, grp_order, n_groups):
        # MEAN = SUM/COUNT finalized in float64 (object columns divide
        # in Python) — the shared shippable-partials definition; float
        # inputs inherit the SUM summation-order carve-out.
        if values.dtype == object:
            if n_groups == 0:
                return (np.array([], dtype=object),
                        np.array([], dtype=bool))
            sums, has = self._aggregate_object(values, ok, order, bounds,
                                               grp_order, n_groups)
            counts = np.add.reduceat(
                ok[order].astype(np.int64), bounds)[grp_order]
            res = np.array([None if a is None else a / c
                            for a, c in zip(sums, counts)], dtype=object)
            return res, has
        sums, has = self._aggregate(values, ok, order, bounds, grp_order,
                                    n_groups)
        if n_groups == 0:
            return np.array([], dtype=np.float64), has
        counts = np.add.reduceat(
            ok[order].astype(np.int64), bounds)[grp_order]
        means = sums.astype(np.float64)
        np.divide(means, counts, out=means, where=has)
        means[~has] = fill_value(np.dtype(np.float64))
        return means, has

    def _agg_minmax(self, fn, values, ok, order, bounds, grp_order,
                    n_groups):
        vdt = values.dtype
        if n_groups == 0:
            return (np.array([], dtype=vdt), np.array([], dtype=bool))
        if vdt != object and vdt.kind in "fiub":
            # invalid lanes are parked at the identity so they never
            # win; NaN in a *valid* float lane propagates through
            # minimum/maximum.reduceat exactly like the reference's
            # per-row np.minimum accumulation.
            ident = reduce_ident(vdt, fn)
            masked = np.where(ok, values, ident)[order]
            ufunc = np.minimum if fn == "min" else np.maximum
            red = ufunc.reduceat(masked, bounds)[grp_order]
            counts = np.add.reduceat(
                ok[order].astype(np.int64), bounds)[grp_order]
            has = counts > 0
            red[~has] = fill_value(vdt)
            return red, has
        # object / datetime values: reference-style row-order
        # accumulation per group run.
        n = len(values)
        ends = np.r_[bounds[1:], n]
        acc: list = [None] * n_groups
        for slot, g in enumerate(grp_order):
            a = None
            for row in order[bounds[g]:ends[g]]:
                if not ok[row]:
                    continue
                v = values[row]
                if a is None:
                    a = v
                elif vdt == object:
                    if fn == "min":
                        a = v if v < a else a
                    else:
                        a = v if v > a else a
                else:
                    a = (np.minimum if fn == "min" else np.maximum)(a, v)
            acc[slot] = a
        red = np.array([fill_value(vdt) if a is None else a
                        for a in acc], dtype=vdt)
        has = np.array([a is not None for a in acc], dtype=bool)
        return red, has

    def _aggregate(self, values: np.ndarray, ok: np.ndarray,
                   order: np.ndarray, bounds: np.ndarray,
                   grp_order: np.ndarray, n_groups: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Per-group SUM over valid lanes; (sums, group-has-a-value).
        ``order``/``bounds``/``grp_order`` come from :func:`_group_runs`;
        invalid groups carry the canonical fill payload."""
        vdt = values.dtype
        if n_groups == 0:               # reduceat rejects empty bounds
            return (np.array([], dtype=vdt), np.array([], dtype=bool))
        if vdt == object:
            return self._aggregate_object(values, ok, order, bounds,
                                          grp_order, n_groups)
        # invalid lanes contribute the additive identity instead of
        # being dropped: exact for integers, and for floats at most a
        # signed-zero/ulp effect inside the documented float carve-out.
        masked = np.where(ok, values, np.zeros(1, dtype=vdt)[0])[order]
        # row order within a run is preserved (stable sort), so integer
        # sums are bit-identical to the reference; float sums can differ
        # in the last ulp (SIMD partial sums). dtype=vdt keeps the
        # accumulator in the value dtype (reduceat would otherwise
        # promote small ints to platform int, changing wraparound).
        sums = np.add.reduceat(masked, bounds, dtype=vdt)[grp_order]
        counts = np.add.reduceat(
            ok[order].astype(np.int64), bounds)[grp_order]
        has = counts > 0
        sums[~has] = fill_value(vdt)    # canonical fill (zeros)
        return sums, has

    @staticmethod
    def _aggregate_object(values: np.ndarray, ok: np.ndarray,
                          order: np.ndarray, bounds: np.ndarray,
                          grp_order: np.ndarray, n_groups: int
                          ) -> tuple[np.ndarray, np.ndarray]:
        # Python-object arithmetic cannot vectorize: reference-style
        # row-order accumulation, one Python loop per group run.
        n = len(values)
        ends = np.r_[bounds[1:], n]
        acc: list = [None] * n_groups
        for slot, g in enumerate(grp_order):
            a = None
            for row in order[bounds[g]:ends[g]]:
                if ok[row]:
                    v = values[row]
                    a = v if a is None else a + v
            acc[slot] = a
        sums = np.array([fill_value(values.dtype) if a is None else a
                         for a in acc], dtype=values.dtype)
        has = np.array([a is not None for a in acc], dtype=bool)
        return sums, has
