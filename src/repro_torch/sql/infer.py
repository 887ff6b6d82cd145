"""Schema inference for compiled SQL queries (DESIGN.md §13).

The contract a query publishes is *inferred, not trusted*: scalar
expressions are evaluated over a one-row dummy table built from the
input contracts (nullable columns get an all-invalid validity mask), so
the inferred dtype/nullability is whatever the house expression kernels
actually produce — inference and execution can never disagree, because
they run the same code. Aggregate outputs follow explicit rules that
mirror the backend contract (``repro_torch.exec``, held bit-identical across
backends by the differential suite):

- ``count`` -> int64, never NULL;
- ``sum``   -> input dtype, NULL iff the input is nullable
  (an all-NULL group sums to NULL); int/float inputs only;
- ``mean``  -> float64 (SUM/COUNT finalized in float64), NULL iff the
  input is nullable; int/float inputs only;
- ``min``/``max`` -> input dtype, NULL iff the input is nullable;
  any input type (str/datetime compare lexicographically/temporally).

Group keys pass through unchanged — SQL groups all NULL keys into ONE
group, so a nullable key stays nullable.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import schema as S
from repro_torch.data.tables import Expr, Table, _ColumnData, _NP_TO_LOGICAL
from repro_torch.sql.errors import SqlCompileError

__all__ = ["ColInfo", "dummy_table", "infer_expr", "agg_result"]

# (dtype, nullable) — the namespace entry for one visible column.
ColInfo = tuple[S.DType, bool]

_SAMPLE = {
    "int": 1, "float": 1.0, "bool": True,
}


def _sample_array(dtype: S.DType) -> np.ndarray:
    if dtype.family == "str":
        out = np.empty(1, dtype=object)
        out[0] = "a"
        return out
    if dtype.family == "datetime":
        return np.array(["2000-01-01"], dtype="datetime64[ns]")
    np_dtype = np.dtype(dtype.name)
    return np.array([_SAMPLE[dtype.family]], dtype=np_dtype)


def dummy_table(ns: Mapping[str, ColInfo]) -> Table:
    """One-row table matching a column namespace. Nullable columns are
    all-invalid so any expression touching them reports a nullable
    result — exactly the worst case the contract must cover."""
    data = {}
    for name, (dtype, nullable) in ns.items():
        valid = np.array([False]) if nullable else None
        data[name] = _ColumnData(_sample_array(dtype), valid)
    return Table(_data=data)


def infer_expr(expr: Expr, dummy: Table, *,
               context: str, what: str) -> ColInfo:
    """Dtype/nullability of ``expr`` by actually evaluating it."""
    try:
        vals, valid = expr.evaluate(dummy)
    except Exception as e:
        raise SqlCompileError(
            f"cannot type {what} at {context}: {e}") from e
    vals = np.asarray(vals)
    key = str(vals.dtype)
    logical = _NP_TO_LOGICAL.get(key)
    if logical is None and np.issubdtype(vals.dtype, np.datetime64):
        logical = "datetime"
    if logical is None:
        raise SqlCompileError(
            f"{what} at {context} produces unsupported dtype "
            f"{vals.dtype}")
    nullable = valid is not None and not bool(np.asarray(valid).all())
    return S.as_dtype(logical), nullable


def agg_result(fn: str, arg: ColInfo, *, context: str,
               display: str) -> ColInfo:
    """Output (dtype, nullable) of one aggregate call per the backend
    contract; raises on type-illegal aggregations."""
    dtype, nullable = arg
    if fn == "count":
        return S.INT64, False
    if fn in ("sum", "mean"):
        if dtype.family not in ("int", "float"):
            raise SqlCompileError(
                f"{fn.upper()}({display}) at {context}: requires a "
                f"numeric argument, got {dtype.name}")
        return (S.FLOAT64 if fn == "mean" else dtype), nullable
    if fn in ("min", "max"):
        return dtype, nullable
    raise SqlCompileError(              # pragma: no cover - parser gates
        f"unknown aggregate {fn!r} at {context}")


def schema_columns(ns: Mapping[str, ColInfo]) -> dict[str, S.Column]:
    """Namespace -> fresh Column objects (no lineage)."""
    return {name: S.Column(name, dtype, nullable=nullable)
            for name, (dtype, nullable) in ns.items()}


def namespace_of(schema: type[S.Schema],
                 columns: Sequence[str] | None = None
                 ) -> dict[str, ColInfo]:
    """Contract -> namespace mapping."""
    cols = schema.columns()
    names = columns if columns is not None else list(cols)
    return {n: (cols[n].dtype, cols[n].nullable) for n in names}
