"""Logical-plan IR: the rewrite target of the optimizer (DESIGN.md §11).

A :class:`DeclarativeNode` lowers to a small tree of relational ops —
``Scan`` / ``Filter`` / ``Project`` / ``Aggregate`` / ``Join`` /
``Reorder`` — that the
optimizer's ``Plan -> Plan`` passes restructure (pushdown, reordering,
pruning, probe fusion) and the engine executes in place of the node's
original body. The IR is deliberately tiny: it models exactly the
declarative subset whose semantics the contracts make checkable, which
is what keeps every rewrite *provable* (the differential suite pins
optimized against unoptimized execution bit for bit) instead of
hopeful.

Design rules:

- ops are frozen dataclasses; a rewrite builds new trees, never mutates;
- ``describe()`` is structural and total — it is cache-key material
  (``PlanStep.cache_material`` folds it), so two trees computing
  different results must never describe identically. That holds only
  when every embedded expression is ``_structural``;
  :meth:`LogicalOp.is_structural` gates caching exactly like
  ``DeclarativeNode.cache_material``;
- execution dispatches through the *active* execution backend
  (``repro_torch.exec``), same as the Table layer — the IR adds no physical
  operator of its own except ``Reorder``'s row-order restoration;
- per-op stats: ``Scan`` forwards the planner-collected ``TableStats``
  of its table; every other op yields ``None`` — a downstream consumer
  (the ``auto`` backend via ``accepts_join_stats``) then measures the
  *post-rewrite* intermediate exactly once at dispatch, which is the
  honest input for backend selection after a rewrite changed the data.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch import exec as exec_backends
from repro_torch.data.tables import Expr, Table, _ColumnData

__all__ = ["LogicalOp", "Scan", "Filter", "Project", "Aggregate",
           "Join", "Reorder", "Sort", "Limit"]


def _pred_mask(t: Table, pred: Expr | None) -> np.ndarray | None:
    if pred is None:
        return None
    mask, valid = pred.evaluate(t)
    mask = np.asarray(mask, dtype=bool)
    if valid is not None:
        mask = mask & valid      # SQL semantics: NULL predicate = drop
    return mask


class LogicalOp:
    """Base of the IR ops (frozen dataclasses; see module docstring)."""

    def children(self) -> tuple["LogicalOp", ...]:
        return ()

    def _own_exprs(self) -> tuple[Expr, ...]:
        return ()

    def describe(self) -> str:
        raise NotImplementedError

    def is_structural(self) -> bool:
        """True iff ``describe()`` faithfully identifies the computation
        — i.e. every expression anywhere in the tree was built through
        the library constructors. Mirrors the uncacheable-node rule of
        ``DeclarativeNode.cache_material``."""
        return (all(getattr(e, "_structural", False)
                    for e in self._own_exprs())
                and all(c.is_structural() for c in self.children()))

    def scan_tables(self) -> set[str]:
        out: set[str] = set()
        for c in self.children():
            out |= c.scan_tables()
        return out

    def execute(self, tables: Mapping[str, Table],
                stats: "Mapping[str, object] | None" = None) -> Table:
        return self._exec(tables, stats or {})[0]

    def _exec(self, tables, stats):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Scan(LogicalOp):
    """Read one input table, optionally keeping only ``columns``.

    Column pruning is zero-copy (the kept ``_ColumnData`` objects are
    shared) and order-preserving (physical column order of the source,
    filtered). ``columns=None`` means all."""

    table: str
    columns: tuple[str, ...] | None = None

    def describe(self) -> str:
        if self.columns is None:
            return f"scan({self.table})"
        return f"scan({self.table}, cols={sorted(self.columns)})"

    def scan_tables(self) -> set[str]:
        return {self.table}

    def _exec(self, tables, stats):
        t = tables[self.table]
        if self.columns is not None:
            keep = set(self.columns)
            t = Table(_data={n: t._data[n] for n in t.column_names()
                             if n in keep})
        return t, stats.get(self.table)


@dataclasses.dataclass(frozen=True)
class Filter(LogicalOp):
    child: LogicalOp
    pred: Expr

    def children(self):
        return (self.child,)

    def _own_exprs(self):
        return (self.pred,)

    def describe(self) -> str:
        return f"filter({self.pred.describe()}, {self.child.describe()})"

    def _exec(self, tables, stats):
        t, _ = self.child._exec(tables, stats)
        return t.filter(self.pred), None


@dataclasses.dataclass(frozen=True)
class Project(LogicalOp):
    child: LogicalOp
    exprs: tuple[Expr, ...]

    def children(self):
        return (self.child,)

    def _own_exprs(self):
        return self.exprs

    def describe(self) -> str:
        return (f"project({[e.describe() for e in self.exprs]}, "
                f"{self.child.describe()})")

    def _exec(self, tables, stats):
        t, _ = self.child._exec(tables, stats)
        return t.select(list(self.exprs)), None


@dataclasses.dataclass(frozen=True)
class Aggregate(LogicalOp):
    """Multi-function GROUP BY: one output row per distinct key tuple
    (first-appearance order), key columns first, then one column per
    ``(fn, value, out)`` spec. Semantics are the execution backends'
    ``group_by_agg`` contract (``repro_torch.exec.base``): SQL NULL handling,
    the reference backend as the bit-for-bit oracle, float SUM/MEAN
    exact only up to summation order.

    ``strategy`` is physical routing, not semantics: ``"auto"`` (the
    default) dispatches through the active backend; ``"partial"`` — set
    only by the optimizer's ``partial_agg`` rewrite — requests the
    registered ``partitioned`` backend's per-partition partial
    aggregation, degrading to the active backend when it does not
    construct here (every
    strategy computes the same table; only float summation order can
    differ, which is exactly why a non-default strategy is rendered in
    ``describe()`` and therefore moves the cache key)."""

    child: LogicalOp
    keys: tuple[str, ...]
    specs: tuple[tuple[str, str, str], ...]
    strategy: str = "auto"

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        specs = [f"{fn}({value})->{out}" for fn, value, out in self.specs]
        strat = "" if self.strategy == "auto" \
            else f", strategy={self.strategy}"
        return (f"aggregate(keys={list(self.keys)}, specs={specs}"
                f"{strat}, {self.child.describe()})")

    def _exec(self, tables, stats):
        t, ts = self.child._exec(tables, stats)
        be = exec_backends.resolve(None)
        if self.strategy == "partial":
            try:
                be = exec_backends.get_backend("partitioned")
            except (KeyError, exec_backends.BackendUnavailable):
                pass    # no card on this install; any backend is correct
        kwargs = {}
        if getattr(be, "accepts_group_stats", False):
            kwargs = {"stats": ts}
        cols = be.group_by_agg(t._to_cols(), self.keys, self.specs,
                               **kwargs)
        return Table._from_cols(cols), None


def holds_partial(op: LogicalOp) -> bool:
    """True iff the tree holds an ``Aggregate(strategy="partial")``: it
    then runs on the registered ``partitioned`` backend, whose layout
    the cache key must carry (``engine.cache_key``)."""
    return ((isinstance(op, Aggregate) and op.strategy == "partial")
            or any(holds_partial(c) for c in op.children()))


@dataclasses.dataclass(frozen=True)
class Join(LogicalOp):
    """Hash join; ``left_pred``/``right_pred`` are filter predicates
    fused into the probe (the probe-fusion rewrite's target) — the
    semantics are filter-each-side-then-join, realized through
    ``Backend.masked_hash_join`` so backends can skip the intermediate
    materialization."""

    left: LogicalOp
    right: LogicalOp
    on: tuple[str, ...]
    how: str = "inner"
    left_pred: Expr | None = None
    right_pred: Expr | None = None

    def children(self):
        return (self.left, self.right)

    def _own_exprs(self):
        return tuple(p for p in (self.left_pred, self.right_pred)
                     if p is not None)

    def describe(self) -> str:
        parts = [self.left.describe(), self.right.describe(),
                 f"on={sorted(self.on)}", f"how={self.how}"]
        if self.left_pred is not None:
            parts.append(f"lpred={self.left_pred.describe()}")
        if self.right_pred is not None:
            parts.append(f"rpred={self.right_pred.describe()}")
        return f"join({', '.join(parts)})"

    def _exec(self, tables, stats):
        lt, ls = self.left._exec(tables, stats)
        rt, rs = self.right._exec(tables, stats)
        be = exec_backends.resolve(None)
        kwargs = {}
        if getattr(be, "accepts_join_stats", False):
            kwargs = {"left_stats": ls, "right_stats": rs}
        if self.left_pred is None and self.right_pred is None:
            cols = be.hash_join(lt._to_cols(), rt._to_cols(),
                                tuple(self.on), self.how, **kwargs)
        else:
            cols = be.masked_hash_join(
                lt._to_cols(), rt._to_cols(), tuple(self.on), self.how,
                left_mask=_pred_mask(lt, self.left_pred),
                right_mask=_pred_mask(rt, self.right_pred), **kwargs)
        return Table._from_cols(cols), None


@dataclasses.dataclass(frozen=True)
class Sort(LogicalOp):
    """Stable multi-key sort (the SQL ORDER BY target).

    ``keys`` are ``(column, ascending)`` pairs, primary key first. SQL
    NULL placement: NULLs sort *last* under ASC and *first* under DESC
    (the larger-than-everything convention). Float NaN follows the same
    convention as a quasi-NULL payload: last under ASC, first under
    DESC (``np.unique`` orders NaN after every finite value). Ties keep
    the child's row order (stability via a final row-id tiebreak), so
    the output is a deterministic function of the child table alone —
    no backend dispatch, same as ``Reorder``'s restoration lexsort."""

    child: LogicalOp
    keys: tuple[tuple[str, bool], ...]

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        keys = [f"{name} {'asc' if asc else 'desc'}"
                for name, asc in self.keys]
        return f"sort(keys={keys}, {self.child.describe()})"

    def _exec(self, tables, stats):
        t, _ = self.child._exec(tables, stats)
        n = len(t)
        # np.lexsort: LAST key is primary -> build (tiebreak, k_last,
        # ..., k_first). Per-key dense ranks via np.unique make object
        # (str) and datetime columns sortable uniformly and give NULLs
        # an explicit rank slot.
        lex: list[np.ndarray] = [np.arange(n, dtype=np.int64)]
        for name, asc in reversed(self.keys):
            c = t._data[name]
            ok = (c.valid if c.valid is not None
                  else np.ones(n, dtype=bool))
            rank = np.zeros(n, dtype=np.int64)
            if ok.any():
                _, inv = np.unique(c.values[ok], return_inverse=True)
                rank[ok] = inv
            k = int(rank.max()) + 1 if n else 0
            rank[~ok] = k            # NULLs above every value...
            if not asc:
                rank = -rank         # ...so DESC puts them first
            lex.append(rank)
        perm = np.lexsort(tuple(lex))
        data = {nm: _ColumnData(
            c.values[perm],
            None if c.valid is None else c.valid[perm])
            for nm, c in t._data.items()}
        return Table(_data=data), None


@dataclasses.dataclass(frozen=True)
class Limit(LogicalOp):
    """Keep the first ``n`` rows of the child (SQL LIMIT)."""

    child: LogicalOp
    n: int

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        return f"limit({self.n}, {self.child.describe()})"

    def _exec(self, tables, stats):
        t, _ = self.child._exec(tables, stats)
        if len(t) <= self.n:
            return t, None
        data = {nm: _ColumnData(
            c.values[:self.n],
            None if c.valid is None else c.valid[:self.n])
            for nm, c in t._data.items()}
        return Table(_data=data), None


@dataclasses.dataclass(frozen=True)
class Reorder(LogicalOp):
    """An all-inner left-deep join chain executed in a cost-chosen
    ``order``, with the original row/column order restored afterwards.

    ``sides`` are ``(op, on)`` pairs as authored; ``order`` permutes
    their *execution*. Soundness (why bit-for-bit holds): the emitted
    match combinations form a duplicate-free set independent of join
    order; the canonical left-deep emission order is lexicographic in
    (base row, side-0 row, side-1 row, ...) because each inner join
    emits left rows in order with matches in right-occurrence order —
    so tagging every input with a row id, joining in the chosen order,
    and lexsorting on the ids reproduces the canonical order exactly.
    Column copies are order-independent because the rewrite requires
    pairwise-disjoint side column sets (base stays leftmost, so
    base-vs-side shadowing resolves to the base copy in every order).
    The restoration lexsort is the price of bit-for-bit; the win is
    probing small tables first."""

    base: LogicalOp
    sides: tuple[tuple[LogicalOp, tuple[str, ...]], ...]
    order: tuple[int, ...]

    def children(self):
        return (self.base,) + tuple(op for op, _ in self.sides)

    def describe(self) -> str:
        sides = ", ".join(f"({op.describe()}, on={sorted(on)})"
                          for op, on in self.sides)
        return (f"reorder(base={self.base.describe()}, "
                f"sides=[{sides}], order={list(self.order)})")

    def _exec(self, tables, stats):
        bt, _ = self.base._exec(tables, stats)
        side_tabs = [op._exec(tables, stats)[0] for op, _ in self.sides]

        # canonical output column order: base's, then each side's new
        # columns in *authored* side order (left-copy-wins).
        seen = set(bt.column_names())
        canon_cols = list(bt.column_names())
        for st in side_tabs:
            for n in st.column_names():
                if n not in seen:
                    seen.add(n)
                    canon_cols.append(n)

        rid = [f"__reorder_rowid{i}__" for i in range(len(side_tabs) + 1)]
        if any(r in seen for r in rid):
            # row-id name collision with a physical column: fall back
            # to the canonical fold (correct, just unoptimized).
            t = bt
            for (op, on), st in zip(self.sides, side_tabs):
                t = t.join(st, on=list(on), how="inner")
            return t, None

        def tag(t: Table, name: str) -> Table:
            data = dict(t._data)
            data[name] = _ColumnData(np.arange(len(t), dtype=np.int64))
            return Table(_data=data)

        acc = tag(bt, rid[0])
        for k in self.order:
            acc = acc.join(tag(side_tabs[k], rid[k + 1]),
                           on=list(self.sides[k][1]), how="inner")

        ids = tuple(acc.column(r) for r in rid)
        # np.lexsort: LAST key is primary -> reversed puts the base row
        # id first. Id tuples are unique (duplicate-free match set), so
        # stability never matters.
        perm = np.lexsort(tuple(reversed(ids)))
        data = {}
        for n in canon_cols:
            c = acc._data[n]
            data[n] = _ColumnData(
                c.values[perm],
                None if c.valid is None else c.valid[perm])
        return Table(_data=data), None
