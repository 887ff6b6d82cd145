"""Typed table contracts (paper §3.1, Listings 3–5, Appendix A).

A :class:`Schema` is an explicit, machine-checkable description of the
columns that flow across a pipeline boundary. Schemas are authored either
with the class syntax of the paper::

    class ParentSchema(Schema):
        col1: str
        col2: datetime
        _S:   int

    class ChildSchema(Schema):
        col2: datetime              # inherited type (checked by lineage)
        col4: float                 # fresh
        col5: Nullable[str]         # fresh, nullable (UNION(str, None))

    class FriendSchema(Schema):     # Appendix A: explicit inheritance
        col2 = ChildSchema.col2         # inherited
        col4 = Grand.col4               # inherited from a second input
        col5 = ChildSchema.col5[NotNull]  # inherited, null-ness *narrowed*

or programmatically (``Schema.of(col1=STR, ...)``). Columns carry a
logical type, nullability, and — when authored by reference — an explicit
*lineage* pointer to the (schema, column) they inherit from.

Type *narrowing* (e.g. ``float → int``) is legal across an edge only when
the consuming transformation declares an explicit cast (paper Listing 5);
the composition rules live in :mod:`repro_torch.core.contracts`.

:class:`TensorContract` extends the same idea to array-valued pipeline
artifacts (parameter pytrees, activations): shape / dtype / sharding are
the "columns" of a tensor, checked with ``jax.eval_shape`` at the control
plane and against concrete arrays at the worker.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any, Mapping, Sequence

from repro_torch.core.errors import ContractAuthoringError

__all__ = [
    "DType", "INT", "FLOAT", "STR", "BOOL", "DATETIME",
    "Nullable", "NotNull", "Column", "ColumnRef", "Schema",
    "TensorContract", "narrowable", "widenable",
]


# ---------------------------------------------------------------------------
# Logical column types
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DType:
    """A logical column type with a total widening order within a family."""

    name: str
    family: str     # "int" | "float" | "str" | "bool" | "datetime"
    rank: int       # widening rank within the family (higher = wider)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


INT8 = DType("int8", "int", 0)
INT16 = DType("int16", "int", 1)
INT32 = DType("int32", "int", 2)
INT64 = DType("int64", "int", 3)
FLOAT16 = DType("float16", "float", 0)
BFLOAT16 = DType("bfloat16", "float", 0)
FLOAT32 = DType("float32", "float", 1)
FLOAT64 = DType("float64", "float", 2)
STR = DType("str", "str", 0)
BOOL = DType("bool", "bool", 0)
DATETIME = DType("datetime", "datetime", 0)

# Default ranks for Python annotation types (paper's class syntax).
INT = INT64
FLOAT = FLOAT64

_PY_TO_DTYPE: dict[Any, DType] = {
    int: INT, float: FLOAT, str: STR, bool: BOOL,
    _dt.datetime: DATETIME,
    "int": INT, "float": FLOAT, "str": STR, "bool": BOOL,
    "datetime": DATETIME,
}

_NAME_TO_DTYPE = {d.name: d for d in
                  (INT8, INT16, INT32, INT64, FLOAT16, BFLOAT16,
                   FLOAT32, FLOAT64, STR, BOOL, DATETIME)}


def as_dtype(t: Any) -> DType:
    if isinstance(t, DType):
        return t
    if isinstance(t, _NullableMarker):
        raise ContractAuthoringError(
            "Nullable[...] resolved outside of a column position")
    if t in _PY_TO_DTYPE:
        return _PY_TO_DTYPE[t]
    if isinstance(t, str) and t in _NAME_TO_DTYPE:
        return _NAME_TO_DTYPE[t]
    raise ContractAuthoringError(f"unsupported column type: {t!r}")


def narrowable(src: DType, dst: DType) -> bool:
    """True if ``src`` can be *narrowed* to ``dst`` via an explicit cast.

    Narrowing is only defined within or across numeric families
    (float→int, int with smaller rank, float with smaller rank).
    """
    if src == dst:
        return True
    if src.family == dst.family:
        return dst.rank < src.rank
    return src.family == "float" and dst.family == "int"


def widenable(src: DType, dst: DType) -> bool:
    """True if ``src`` flows to ``dst`` with *no* cast (identity or widening)."""
    if src == dst:
        return True
    if src.family == dst.family:
        return dst.rank > src.rank
    return src.family == "int" and dst.family == "float"


# ---------------------------------------------------------------------------
# Nullability markers
# ---------------------------------------------------------------------------

class _NullableMarker:
    """``Nullable[str]`` ≈ the paper's ``UNION(str, None)``."""

    def __init__(self, inner: Any):
        self.inner = inner

    def __class_getitem__(cls, inner: Any) -> "_NullableMarker":
        return cls(inner)


class Nullable(_NullableMarker):
    pass


class _NotNullTag:
    """``ChildSchema.col5[NotNull]`` — narrow nullability on inheritance."""

    def __repr__(self) -> str:  # pragma: no cover
        return "NotNull"


NotNull = _NotNullTag()


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Column:
    """A single column contract."""

    name: str
    dtype: DType
    nullable: bool = False
    # lineage: fully-qualified "<SchemaName>.<col>" this column inherits from,
    # or None for a fresh column.
    inherited_from: str | None = None

    def with_name(self, name: str) -> "Column":
        return dataclasses.replace(self, name=name)

    def __getitem__(self, tag: Any) -> "Column":
        # Appendix A: `ChildSchema.col5[NotNull]` — explicit null filtering.
        if tag is NotNull or isinstance(tag, _NotNullTag):
            return dataclasses.replace(self, nullable=False)
        raise ContractAuthoringError(f"unknown column tag: {tag!r}")

    def describe(self) -> str:
        n = "?" if self.nullable else ""
        lin = f" <- {self.inherited_from}" if self.inherited_from else ""
        return f"{self.name}: {self.dtype.name}{n}{lin}"


class ColumnRef(Column):
    """Alias kept for API clarity: a Column obtained via ``Schema.col``."""


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

class _SchemaMeta(type):
    """Metaclass implementing the paper's class-based schema syntax."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        if ns.get("_abstract_", False):
            cls._columns_ = {}
            return cls
        columns: dict[str, Column] = {}
        # inherited (python-level) columns from base Schemas
        for base in bases:
            columns.update(getattr(base, "_columns_", {}))
        # 1) annotation syntax: `col: type`
        for cname, ann in ns.get("__annotations__", {}).items():
            if cname.startswith("__"):
                continue
            nullable = False
            t = ann
            if isinstance(t, _NullableMarker):
                nullable, t = True, t.inner
            columns[cname] = Column(cname, as_dtype(t), nullable=nullable)
        # 2) assignment syntax: `col = OtherSchema.other_col` (Appendix A)
        for cname, val in ns.items():
            if cname.startswith("_") or cname in columns:
                continue
            if isinstance(val, Column):
                # `val.inherited_from` was stamped with "<Owner>.<col>" when
                # the owning schema class re-exposed it as an attribute.
                columns[cname] = dataclasses.replace(val, name=cname)
        cls._columns_ = columns
        # re-expose columns as attributes carrying owner info so that
        # `MySchema.col` can be used for inheritance in *other* schemas.
        for cname, col in columns.items():
            owned = dataclasses.replace(
                col, inherited_from=col.inherited_from or f"{name}.{cname}")
            setattr(cls, cname, owned)
        return cls

    def __iter__(cls):
        return iter(cls._columns_.values())


class Schema(metaclass=_SchemaMeta):
    """Base class for table contracts (the paper's ``BauplanSchema``)."""

    _abstract_ = True
    _columns_: dict[str, Column] = {}

    # -- programmatic construction -------------------------------------
    @classmethod
    def of(cls, __name: str = "AnonymousSchema", **cols: Any) -> type["Schema"]:
        ns: dict[str, Any] = {"__annotations__": {}}
        for cname, t in cols.items():
            if isinstance(t, Column):
                ns[cname] = t
            else:
                ns["__annotations__"][cname] = t
        return _SchemaMeta(__name, (Schema,), ns)

    # -- introspection ---------------------------------------------------
    @classmethod
    def columns(cls) -> Mapping[str, Column]:
        return dict(cls._columns_)

    @classmethod
    def names(cls) -> Sequence[str]:
        return list(cls._columns_)

    @classmethod
    def describe(cls) -> str:
        body = "\n".join(f"  {c.describe()}" for c in cls._columns_.values())
        return f"{cls.__name__}:\n{body}"

    @classmethod
    def fingerprint(cls) -> str:
        import hashlib
        h = hashlib.sha256()
        for c in sorted(cls._columns_.values(), key=lambda c: c.name):
            h.update(c.describe().encode())
        return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Tensor contracts (hardware adaptation: contracts for array artifacts)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorContract:
    """Contract for one array artifact crossing a pipeline boundary.

    ``shape`` entries may be ints or named symbolic dims (strings), which
    must bind consistently across all tensors validated together.
    ``spec`` optionally pins a :class:`jax.sharding.PartitionSpec`-like
    tuple so distribution intent is part of the contract.
    """

    shape: tuple[Any, ...]
    dtype: str
    spec: tuple[Any, ...] | None = None
    allow_nan: bool = False

    def validate_abstract(self, aval, bindings: dict[str, int],
                          name: str = "<tensor>") -> None:
        from repro_torch.core.errors import ContractCompositionError
        if str(aval.dtype) != self.dtype:
            raise ContractCompositionError(
                f"{name}: dtype {aval.dtype} != contract {self.dtype}")
        if len(aval.shape) != len(self.shape):
            raise ContractCompositionError(
                f"{name}: rank {len(aval.shape)} != contract rank "
                f"{len(self.shape)}")
        for i, (got, want) in enumerate(zip(aval.shape, self.shape)):
            if isinstance(want, str):
                bound = bindings.setdefault(want, got)
                if bound != got:
                    raise ContractCompositionError(
                        f"{name}: dim {i} symbol {want!r} bound to {bound} "
                        f"but saw {got}")
            elif want != got:
                raise ContractCompositionError(
                    f"{name}: dim {i} is {got}, contract says {want}")

    def validate_concrete(self, arr, name: str = "<tensor>") -> None:
        import numpy as np
        from repro_torch.core.errors import ContractRuntimeError
        arr = np.asarray(arr)    # numpy arrays and CPU torch tensors
        self_bindings: dict[str, int] = {}
        try:
            self.validate_abstract(arr, self_bindings, name)
        except Exception as e:  # re-raise at WORKER moment
            raise ContractRuntimeError(str(e)) from e
        if not self.allow_nan and np.issubdtype(arr.dtype, np.floating):
            if bool(np.isnan(arr).any()):
                raise ContractRuntimeError(f"{name}: contract forbids NaNs")
