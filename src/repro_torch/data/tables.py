"""Columnar tables and the expression language of the paper's listings.

A :class:`Table` is an immutable set of named columns (numpy-backed, with
validity masks for nullability) — the in-memory stand-in for an Iceberg
table snapshot. The expression API mirrors the paper's nodes::

    df.select([col('col2'),
               lit(0.5).alias('col4'),
               arrow_cast(col('col4'), str_lit('Int64')).alias('col4')])
    df.filter(col('col5').is_not_null() & ((col('a') - col('b')) < 0.5))
    df.join(other, on=['col2'], how='inner')

Logical dtypes follow :mod:`repro_torch.core.schema` so worker-side contract
validation (:func:`repro_torch.core.contracts.validate_table`) checks *physical*
data against declared schemas, including nullability.

The relational operators dispatch through the pluggable execution
backends of :mod:`repro_torch.exec` (DESIGN.md §9): ``reference`` (row-loop
oracle), ``vectorized`` (numpy), ``torch`` (group-by aggregation in the
CUDA segment kernels, the default). Semantics are backend-independent — the differential
suite (tests/test_exec_backends.py) holds every backend to the
reference bit for bit — and each op takes a per-call ``backend=``
override on top of the process-wide selection.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

from repro_torch import exec as exec_backends

__all__ = ["Table", "GroupedTable", "resolve_agg_specs", "col", "lit",
           "str_lit", "arrow_cast", "Expr"]

_NP_TO_LOGICAL = {
    "int8": "int8", "int16": "int16", "int32": "int32", "int64": "int64",
    "float16": "float16", "float32": "float32", "float64": "float64",
    "bool": "bool", "object": "str", "str": "str",
    "datetime64[ns]": "datetime", "<M8[ns]": "datetime",
}

_LOGICAL_TO_NP = {
    "int8": np.int8, "int16": np.int16, "int32": np.int32,
    "int64": np.int64, "float16": np.float16, "float32": np.float32,
    "float64": np.float64, "bool": np.bool_, "str": object,
    "datetime": "datetime64[ns]",
    # arrow-style names accepted by arrow_cast (paper Listing 5)
    "Int8": np.int8, "Int16": np.int16, "Int32": np.int32,
    "Int64": np.int64, "Float32": np.float32, "Float64": np.float64,
}

_ARROW_TO_LOGICAL = {
    "Int8": "int8", "Int16": "int16", "Int32": "int32", "Int64": "int64",
    "Float32": "float32", "Float64": "float64",
}


def _canon_str_array(arr: np.ndarray) -> np.ndarray:
    """Canonical representation for string columns: object dtype holding
    plain ``str`` / ``None``. Numpy fixed-width ``U``/``S`` arrays (from
    list literals, ``lit``, ``np.full``) are normalized here so the
    logical dtype is always ``str`` and fingerprints/snapshots do not
    depend on the construction path."""
    if arr.dtype.kind == "S":
        arr = np.char.decode(arr, "utf-8")
    out = np.empty(len(arr), dtype=object)
    out[:] = arr.tolist()       # C-level conversion to plain str
    return out


@dataclasses.dataclass(frozen=True)
class _ColumnData:
    values: np.ndarray
    valid: np.ndarray | None = None  # None = no nulls

    def __post_init__(self):
        if self.values.dtype.kind in ("U", "S"):
            object.__setattr__(self, "values",
                               _canon_str_array(self.values))
        if self.valid is not None and not self.valid.all():
            return
        if self.valid is not None:
            object.__setattr__(self, "valid", None)

    @property
    def has_nulls(self) -> bool:
        return self.valid is not None and bool((~self.valid).any())


class Table:
    """Immutable columnar table."""

    def __init__(self, columns: Mapping[str, Any] | None = None,
                 _data: dict[str, _ColumnData] | None = None):
        if _data is not None:
            self._data = _data
        else:
            self._data = {}
            for name, v in (columns or {}).items():
                if isinstance(v, _ColumnData):
                    self._data[name] = v
                    continue
                arr = np.asarray(v)
                valid = None
                if arr.dtype == object:
                    valid = np.array([x is not None for x in arr])
                    if valid.all():
                        valid = None
                self._data[name] = _ColumnData(arr, valid)
        lens = {len(c.values) for c in self._data.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns: lengths {sorted(lens)}")

    # -- introspection -------------------------------------------------
    def column_names(self) -> list[str]:
        return list(self._data)

    def __len__(self) -> int:
        if not self._data:
            return 0
        return len(next(iter(self._data.values())).values)

    @property
    def num_rows(self) -> int:
        return len(self)

    def column(self, name: str) -> np.ndarray:
        return self._data[name].values

    def validity(self, name: str) -> np.ndarray:
        c = self._data[name]
        return (c.valid if c.valid is not None
                else np.ones(len(c.values), dtype=bool))

    def logical_dtype(self, name: str) -> str:
        # numpy U/S string dtypes never reach this point: _ColumnData
        # canonicalizes them to object arrays at construction, and
        # object maps to logical `str` below.
        arr = self._data[name].values
        key = str(arr.dtype)
        if key in _NP_TO_LOGICAL:
            return _NP_TO_LOGICAL[key]
        if np.issubdtype(arr.dtype, np.datetime64):
            return "datetime"
        raise TypeError(f"column {name!r}: unmapped dtype {arr.dtype}")

    def has_nulls(self, name: str) -> bool:
        return self._data[name].has_nulls

    def to_pydict(self) -> dict[str, list]:
        out = {}
        for name, c in self._data.items():
            vals = c.values.tolist()
            if c.valid is not None:
                vals = [v if ok else None
                        for v, ok in zip(vals, c.valid)]
            out[name] = vals
        return out

    def fingerprint(self) -> str:
        import hashlib
        h = hashlib.sha256()
        for name in sorted(self._data):
            c = self._data[name]
            h.update(name.encode())
            if c.values.dtype == object:
                # canonical repr: plain str / None (np.str_ etc. vary
                # by construction path but compare equal)
                canon = [None if v is None else str(v)
                         for v in c.values.tolist()]
                h.update(str(canon).encode())
            else:
                h.update(np.ascontiguousarray(c.values).tobytes())
            if c.valid is not None:
                h.update(c.valid.tobytes())
        return h.hexdigest()[:24]

    # -- serialization (object-store snapshots) -------------------------
    def to_blobs(self, store) -> str:
        """Persist as a content-addressed snapshot; returns manifest key."""
        manifest = {"kind": "table", "columns": {}}
        for name, c in self._data.items():
            vals = c.values
            if vals.dtype == object:
                enc = np.array([("" if v is None else str(v))
                                for v in vals])
                key = store.put_array(enc.astype("U"))
                kind = "str"
            elif np.issubdtype(vals.dtype, np.datetime64):
                key = store.put_array(vals.astype("int64"))
                kind = "datetime"
            else:
                key = store.put_array(vals)
                kind = "plain"
            vkey = (store.put_array(c.valid)
                    if c.valid is not None else None)
            # dtype recorded so schema inference over a snapshot (the
            # SQL front door's catalog discovery) reads the manifest
            # only, never the column blobs; "str"/"datetime" kinds pin
            # the logical dtype already.
            manifest["columns"][name] = {"values": key, "valid": vkey,
                                         "kind": kind,
                                         "dtype": str(vals.dtype)}
        return store.put_json(manifest)

    @classmethod
    def from_blobs(cls, store, key: str) -> "Table":
        manifest = store.get_json(key)
        data: dict[str, _ColumnData] = {}
        for name, m in manifest["columns"].items():
            vals = store.get_array(m["values"])
            valid = (store.get_array(m["valid"])
                     if m["valid"] is not None else None)
            if m["kind"] == "str":
                vals = _canon_str_array(vals)
                if valid is not None:   # true roundtrip: restore None
                    vals[~valid.astype(bool)] = None
            elif m["kind"] == "datetime":
                vals = vals.astype("datetime64[ns]")
            data[name] = _ColumnData(vals, valid)
        return cls(_data=data)

    # -- backend bridge (repro_torch.exec column dicts) ------------------------
    def _to_cols(self) -> dict[str, tuple[np.ndarray, np.ndarray | None]]:
        return {n: (c.values, c.valid) for n, c in self._data.items()}

    @classmethod
    def _from_cols(cls, cols: Mapping[str, tuple]) -> "Table":
        return cls(_data={n: _ColumnData(v, valid)
                          for n, (v, valid) in cols.items()})

    # -- relational ops (paper's node bodies) ----------------------------
    # Expression evaluation stays here; the physical operators dispatch
    # through repro_torch.exec (DESIGN.md §9). `backend=` overrides the
    # process-wide selection for one call.

    def select(self, exprs: Sequence["Expr"]) -> "Table":
        data: dict[str, _ColumnData] = {}
        for e in exprs:
            name = e.output_name()
            vals, valid = e.evaluate(self)
            data[name] = _ColumnData(vals, valid)
        return Table(_data=data)

    def filter(self, pred: "Expr", *,
               backend: "str | None" = None) -> "Table":
        mask, valid = pred.evaluate(self)
        mask = np.asarray(mask, dtype=bool)
        if valid is not None:
            mask = mask & valid  # SQL semantics: NULL predicate = drop row
        be = exec_backends.resolve(backend)
        return Table._from_cols(be.filter_select(self._to_cols(), mask))

    def join(self, other: "Table", on: Sequence[str],
             how: str = "inner", *,
             backend: "str | None" = None) -> "Table":
        """Hash join. ``inner`` drops NULL-keyed rows from both sides
        (NULL = NULL is not TRUE); ``left`` keeps every left row —
        unmatched rows carry NULL right columns with correct validity
        masks."""
        if how not in ("inner", "left"):
            raise NotImplementedError(
                f"join: how={how!r} not supported (inner, left)")
        be = exec_backends.resolve(backend)
        return Table._from_cols(
            be.hash_join(self._to_cols(), other._to_cols(),
                         tuple(on), how))

    def masked_join(self, other: "Table", on: Sequence[str],
                    how: str = "inner", *,
                    left_pred: "Expr | None" = None,
                    right_pred: "Expr | None" = None,
                    backend: "str | None" = None) -> "Table":
        """Filter-fused hash join: semantically identical to
        ``self.filter(left_pred).join(other.filter(right_pred), ...)``
        but the masks travel into the probe so backends can skip the
        intermediate materialization (the optimizer's probe-fusion
        rewrite targets this entry point)."""
        if how not in ("inner", "left"):
            raise NotImplementedError(
                f"masked_join: how={how!r} not supported (inner, left)")

        def _mask(t: "Table", pred: "Expr | None"):
            if pred is None:
                return None
            mask, valid = pred.evaluate(t)
            mask = np.asarray(mask, dtype=bool)
            if valid is not None:
                mask = mask & valid  # SQL: NULL predicate = drop row
            return mask

        be = exec_backends.resolve(backend)
        return Table._from_cols(
            be.masked_hash_join(self._to_cols(), other._to_cols(),
                                tuple(on), how,
                                left_mask=_mask(self, left_pred),
                                right_mask=_mask(other, right_pred)))

    def group_by(self, keys: Sequence[str]) -> "GroupedTable":
        """Declarative multi-function GROUP BY::

            t.group_by(["k"]).agg(("sum", "v"), ("count", "v", "n"))

        Aggregate fns: ``sum``/``count``/``min``/``max``/``mean``. SQL
        NULL semantics throughout (see ``repro_torch.exec.base``): aggregates
        skip NULL values (an all-NULL group is NULL, except COUNT,
        which counts 0 and is never NULL), and all NULL keys form ONE
        group. In a declarative pipeline the same call lowers to the
        ``Aggregate`` logical op instead of executing eagerly."""
        return GroupedTable(self, tuple(keys))

    def group_by_sum(self, keys: Sequence[str], value: str,
                     out: str | None = None, *,
                     backend: "str | None" = None) -> "Table":
        """GROUP BY keys, SUM(value) — the paper's Listing 1 aggregate,
        now a thin wrapper over :meth:`group_by`'s multi-function path
        (the regression suite pins its fingerprints byte-identical to
        the pre-refactor implementation).

        SQL aggregate semantics over nullable columns: NULL values are
        skipped by SUM (a group whose values are all NULL sums to NULL),
        and NULL keys form their own single group — SQL ``GROUP BY``
        treats all NULLs as one group, unlike join equality.

        The output column defaults to ``{value}_sum`` (deterministically
        de-collided against the key names); an explicit ``out`` that
        names a group key raises instead of silently overwriting it.
        """
        spec = ("sum", value) if out is None else ("sum", value, out)
        return GroupedTable(self, tuple(keys)).agg(spec, backend=backend)

    def concat(self, other: "Table", *,
               backend: "str | None" = None) -> "Table":
        be = exec_backends.resolve(backend)
        return Table._from_cols(
            be.concat(self._to_cols(), other._to_cols()))


# ---------------------------------------------------------------------------
# GROUP BY
# ---------------------------------------------------------------------------

def resolve_agg_specs(keys: Sequence[str],
                      specs: Sequence[tuple]) -> tuple[tuple[str, str, str], ...]:
    """Normalize user-facing agg specs — ``(fn, value)`` or
    ``(fn, value, out)`` — into the backend's ``(fn, value, out)``
    triples. Default output names are ``{value}_{fn}``, deterministically
    de-collided (``{value}_{fn}_{i}``) against the group keys and every
    name already taken by an earlier spec — the exact scheme
    ``group_by_sum`` always used, so its pinned names are unchanged. An
    explicit ``out`` that names a group key raises instead of silently
    overwriting it. Shared by the eager Table path and the declarative
    DAG lowering, so both produce identical plans."""
    if not specs:
        raise ValueError("agg: at least one (fn, value[, out]) spec "
                         "is required")
    used = set(keys)
    resolved: list[tuple[str, str, str]] = []
    for spec in specs:
        if len(spec) == 2:
            fn, value = spec
            out = None
        elif len(spec) == 3:
            fn, value, out = spec
        else:
            raise ValueError(
                f"agg: expected (fn, value) or (fn, value, out), "
                f"got {spec!r}")
        if out is None:
            out = f"{value}_{fn}"
            i = 1
            while out in used:
                out = f"{value}_{fn}_{i}"
                i += 1
        elif out in keys:
            raise ValueError(
                f"agg: out={out!r} collides with a group key; "
                f"pick a distinct output column name")
        elif out in used:
            raise ValueError(
                f"agg: out={out!r} is produced by more than one spec")
        used.add(out)
        resolved.append((fn, value, out))
    return tuple(resolved)


class GroupedTable:
    """The result of :meth:`Table.group_by` — holds the keys and waits
    for :meth:`agg` to name the aggregates."""

    def __init__(self, table: Table, keys: tuple[str, ...]):
        self._table = table
        self._keys = keys

    def agg(self, *specs: tuple, backend: "str | None" = None) -> Table:
        """Execute the aggregation: one output row per distinct key
        tuple in first-appearance order, key columns first, then one
        column per spec."""
        resolved = resolve_agg_specs(self._keys, specs)
        be = exec_backends.resolve(backend)
        return Table._from_cols(
            be.group_by_agg(self._table._to_cols(), self._keys,
                            resolved))


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class Expr:
    def __init__(self, fn: Callable[[Table], tuple[np.ndarray, np.ndarray | None]],
                 name: str, desc: str | None = None, *,
                 _structural: bool = False,
                 refs: "frozenset[str] | None" = None):
        self._fn = fn
        self._name = name
        # structural description: unlike the output name it survives
        # alias(), so two expressions computing different values never
        # describe identically (content-addressed cache keys rely on it).
        self._desc = desc if desc is not None else name
        # set only by the library constructors (col/lit/operators/
        # arrow_cast): marks _desc as a faithful description of the
        # computation. Hand-rolled Expr(fn, name) stays False, which
        # makes any declarative node using it uncacheable (dag.py).
        self._structural = _structural
        # input columns this expression reads, or None when unknown
        # (hand-rolled Expr(fn, name) may read anything). The optimizer
        # refuses to push/elide around any expression with None refs.
        self._refs = refs

    def references(self) -> "frozenset[str] | None":
        """Set of input-column names this expression reads; ``None``
        means "unknown — could read anything" (opaque callables)."""
        return self._refs

    def evaluate(self, t: Table) -> tuple[np.ndarray, np.ndarray | None]:
        return self._fn(t)

    def output_name(self) -> str:
        return self._name

    def describe(self) -> str:
        if self._desc == self._name:
            return self._desc
        return f"{self._desc} AS {self._name}"

    def alias(self, name: str) -> "Expr":
        return Expr(self._fn, name, self._desc,
                    _structural=self._structural, refs=self._refs)

    def is_not_null(self) -> "Expr":
        def fn(t: Table):
            _, valid = self._fn(t)
            n = len(t)
            out = (valid.copy() if valid is not None
                   else np.ones(n, dtype=bool))
            return out, None
        return Expr(fn, f"{self._name}_is_not_null",
                    f"is_not_null({self._desc})",
                    _structural=self._structural, refs=self._refs)

    def _binop(self, other: Any, op, sym: str) -> "Expr":
        other_e = other if isinstance(other, Expr) else lit(other)

        def fn(t: Table):
            lv, lva = self._fn(t)
            rv, rva = other_e._fn(t)
            if lva is None and rva is None:
                valid = None
            else:
                la = lva if lva is not None else np.ones(len(t), bool)
                ra = rva if rva is not None else np.ones(len(t), bool)
                valid = la & ra
            if valid is not None and (lv.dtype == object
                                      or rv.dtype == object):
                # NULL lanes of object columns hold None payloads; numpy
                # object-dtype ufuncs evaluate EVERY lane, so e.g.
                # None - 1 raises TypeError even though validity masks
                # the lane out. Evaluate only the valid lanes; invalid
                # lanes keep the canonical object fill (None), so the
                # result fingerprints identically however it was built.
                vals = np.full(len(t), None, dtype=object)
                if valid.any():
                    vals[valid] = op(lv[valid], rv[valid])
            else:
                vals = op(lv, rv)
            return vals, valid
        refs = (self._refs | other_e._refs
                if self._refs is not None and other_e._refs is not None
                else None)
        return Expr(fn, f"({self._name}{sym}{other_e._name})",
                    f"({self._desc}{sym}{other_e._desc})",
                    _structural=self._structural and other_e._structural,
                    refs=refs)

    def _unop(self, op, sym: str) -> "Expr":
        def fn(t: Table):
            vals, valid = self._fn(t)
            return op(vals), valid
        return Expr(fn, f"({sym}{self._name})", f"({sym}{self._desc})",
                    _structural=self._structural, refs=self._refs)

    def __invert__(self): return self._unop(np.logical_not, "~")
    def __neg__(self): return self._unop(np.negative, "-")

    def __add__(self, o): return self._binop(o, np.add, "+")
    def __sub__(self, o): return self._binop(o, np.subtract, "-")
    def __mul__(self, o): return self._binop(o, np.multiply, "*")
    def __truediv__(self, o): return self._binop(o, np.true_divide, "/")
    def __lt__(self, o): return self._binop(o, np.less, "<")
    def __le__(self, o): return self._binop(o, np.less_equal, "<=")
    def __gt__(self, o): return self._binop(o, np.greater, ">")
    def __ge__(self, o): return self._binop(o, np.greater_equal, ">=")
    def __eq__(self, o): return self._binop(o, np.equal, "==")  # type: ignore
    def __ne__(self, o): return self._binop(o, np.not_equal, "!=")  # type: ignore
    def __and__(self, o): return self._binop(o, np.logical_and, "&")
    def __or__(self, o): return self._binop(o, np.logical_or, "|")
    __hash__ = None  # type: ignore


def col(name: str) -> Expr:
    def fn(t: Table):
        c = t._data[name]
        return c.values, c.valid
    return Expr(fn, name, _structural=True, refs=frozenset({name}))


def lit(value: Any) -> Expr:
    def fn(t: Table):
        n = len(t)
        if value is None:
            return (np.zeros(n, dtype=object),
                    np.zeros(n, dtype=bool))
        # canonical string representation: object dtype, never
        # fixed-width <U*> (which logical_dtype could not map)
        dtype = object if isinstance(value, (str, bytes)) else None
        arr = np.full(n, value, dtype=dtype)
        return arr, None
    return Expr(fn, repr(value), _structural=True, refs=frozenset())


def str_lit(value: str) -> str:
    """Paper Listing 5: the cast-target literal of ``arrow_cast``."""
    return value


def arrow_cast(expr: Expr, target: str) -> Expr:
    """Explicit cast (paper Listing 5) — required to legally narrow."""
    np_t = _LOGICAL_TO_NP.get(target)
    if np_t is None:
        raise TypeError(f"arrow_cast: unknown target type {target!r}")

    def fn(t: Table):
        vals, valid = expr.evaluate(t)
        return vals.astype(np_t), valid
    e = Expr(fn, expr.output_name(), f"cast({expr._desc}, {target})",
             _structural=expr._structural, refs=expr._refs)
    e.cast_target = _ARROW_TO_LOGICAL.get(target, target)  # type: ignore
    return e
