"""Contract composition and validation (paper §3.1 + Appendix A).

Three checking *moments* (Figure 1):

1. **Authoring** (:func:`check_wellformed`) — a schema must be internally
   consistent; lineage references must resolve.
2. **Control plane** (:func:`check_edge`, :func:`check_node`) — *before*
   any distributed execution, every edge of the DAG must compose: each
   column a consumer declares as inherited must exist upstream with a
   compatible type; *narrowing* (float→int, nullable→not-null) is legal
   only when the node explicitly declares the cast/filter.
3. **Worker** (:func:`validate_table`) — the physical data must conform
   to the declared output schema before any result is persisted.

"Dafny-style" pre/post-condition propagation (Appendix A): the planner
calls :func:`provable_postconditions` to decide which worker-side checks
are statically discharged and can be elided.
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Iterable, Mapping

from repro_torch.core import schema as S
from repro_torch.core.errors import (
    ContractAuthoringError,
    ContractCompositionError,
    ContractRuntimeError,
)

__all__ = [
    "CastDecl", "check_wellformed", "check_edge", "check_node",
    "validate_table", "provable_postconditions", "EdgeReport",
]


@dataclasses.dataclass(frozen=True)
class CastDecl:
    """An explicit cast declared by a node (``arrow_cast`` in Listing 5)."""

    column: str
    to: S.DType


@dataclasses.dataclass(frozen=True)
class EdgeReport:
    """Result of composing one (upstream → downstream) edge."""

    upstream: str
    downstream: str
    inherited: tuple[str, ...]
    narrowed: tuple[str, ...]
    fresh: tuple[str, ...]

    def describe(self) -> str:
        return (f"{self.upstream} -> {self.downstream}: "
                f"inherited={list(self.inherited)} "
                f"narrowed={list(self.narrowed)} fresh={list(self.fresh)}")


# ---------------------------------------------------------------------------
# Moment 1: authoring
# ---------------------------------------------------------------------------

def check_wellformed(schema: type[S.Schema]) -> None:
    """Raise :class:`ContractAuthoringError` if the schema is ill-formed."""
    seen: set[str] = set()
    for name, col in schema.columns().items():
        if not name.isidentifier():
            raise ContractAuthoringError(
                f"{schema.__name__}.{name}: not a valid column identifier")
        if name in seen:  # pragma: no cover - dict keys are unique
            raise ContractAuthoringError(
                f"{schema.__name__}: duplicate column {name}")
        seen.add(name)
        if col.inherited_from is not None and "." not in col.inherited_from:
            raise ContractAuthoringError(
                f"{schema.__name__}.{name}: malformed lineage "
                f"{col.inherited_from!r}")


# ---------------------------------------------------------------------------
# Moment 2: control plane
# ---------------------------------------------------------------------------

def _resolve_upstream(
    col: S.Column,
    inputs: Mapping[str, type[S.Schema]],
) -> tuple[str, S.Column] | None:
    """Find the upstream column this output column flows from.

    Resolution order: explicit lineage ("Schema.col"), then by-name match
    across inputs (the paper's "col2 is propagated as-is" convention).
    Returns (input schema name, column) or None for fresh columns.

    By-name resolution across MULTIPLE inputs is legal only when every
    candidate declares the same (dtype, nullability) — otherwise the
    composition verdict would depend on input dict ordering (binding
    ``x`` to ``A(x: int32)`` vs ``B(x: int64)`` flips widening into
    narrowing). Ambiguous candidates raise
    :class:`ContractCompositionError`; declare explicit lineage
    (``col = A.x``) to disambiguate.
    """
    if col.inherited_from is not None:
        sname, cname = col.inherited_from.rsplit(".", 1)
        for iname, ischema in inputs.items():
            if ischema.__name__ == sname and cname in ischema.columns():
                return iname, ischema.columns()[cname]
        # lineage names a schema that is not an input: composition error.
        raise ContractCompositionError(
            f"column {col.name!r} declares lineage {col.inherited_from!r} "
            f"but no input provides it (inputs: "
            f"{[s.__name__ for s in inputs.values()]})")
    candidates = [(iname, ischema.columns()[col.name])
                  for iname, ischema in inputs.items()
                  if col.name in ischema.columns()]
    if not candidates:
        return None
    decls = {(c.dtype, c.nullable) for _, c in candidates}
    if len(decls) > 1:
        raise ContractCompositionError(
            f"column {col.name!r} resolves by name against multiple "
            f"inputs with conflicting declarations "
            f"({', '.join(sorted(f'{i}: {c.dtype.name}' + ('?' if c.nullable else '') for i, c in candidates))}): "
            f"declare explicit lineage (e.g. `{col.name} = "
            f"SchemaName.{col.name}`) to disambiguate")
    return candidates[0]


def referenced_columns(
    inputs: Mapping[str, type[S.Schema]],
    output: type[S.Schema],
    computed: Collection[str] = (),
) -> dict[str, set[str]]:
    """Per-input sets of upstream columns the output contract references.

    The elision-soundness input for the optimizer (Appendix A): a source
    column may be dropped from a scan only when it is outside BOTH the
    step's own expression/key references AND this set — contract
    verifiers (``validate_table``) check declared columns of the output,
    and each declared column resolves to at most one upstream column per
    :func:`_resolve_upstream` (explicit lineage first, then by-name).
    Fresh columns (computed, no upstream) reference nothing. Keys are
    the input names used in ``inputs``; every input appears, possibly
    with an empty set.

    ``computed`` names output columns the node *manufactures* — an
    aggregate node's output columns (``agg_specs`` outs) — which must
    not resolve by name: a spec output that happens to reuse an input
    column's name carries aggregated values, not a pass-through, so a
    by-name resolution would anchor an input column the verifier never
    actually reaches (blocking its elision for nothing).
    """
    out: dict[str, set[str]] = {iname: set() for iname in inputs}
    for name, column in output.columns().items():
        if name in computed and column.inherited_from is None:
            continue
        src = _resolve_upstream(column, inputs)
        if src is not None:
            out[src[0]].add(src[1].name)
    return out


def check_edge(
    upstream: type[S.Schema],
    downstream: type[S.Schema],
    casts: Iterable[CastDecl] = (),
) -> EdgeReport:
    """Check that a single edge composes (convenience over check_node)."""
    return check_node({upstream.__name__: upstream}, downstream, casts)


def check_node(
    inputs: Mapping[str, type[S.Schema]],
    output: type[S.Schema],
    casts: Iterable[CastDecl] = (),
) -> EdgeReport:
    """Control-plane composition check for one DAG node.

    For every output column that is inherited (explicitly via lineage, or
    implicitly by name), the upstream type must flow into the declared
    type: identical or widenable with no cast; narrowable only with an
    explicit :class:`CastDecl`; anything else is a composition error.
    Nullability may only be narrowed (nullable → not-null) when declared
    via ``[NotNull]`` lineage or a cast — widening (not-null → nullable)
    is always safe.
    """
    for s in (*inputs.values(), output):
        check_wellformed(s)
    cast_by_col = {c.column: c for c in casts}
    inherited, narrowed, fresh = [], [], []

    for name, col in output.columns().items():
        src = _resolve_upstream(col, inputs)
        if src is None:
            fresh.append(name)
            continue
        _, upcol = src
        inherited.append(name)
        # --- type flow ---
        if S.widenable(upcol.dtype, col.dtype):
            pass  # identity or implicit widening: always legal
        elif S.narrowable(upcol.dtype, col.dtype):
            cast = cast_by_col.get(name)
            if cast is None:
                raise ContractCompositionError(
                    f"{output.__name__}.{name}: narrows {upcol.dtype.name} "
                    f"-> {col.dtype.name} without an explicit cast "
                    f"(paper §3.1: narrowing requires a declared cast)")
            if cast.to != col.dtype:
                raise ContractCompositionError(
                    f"{output.__name__}.{name}: cast target "
                    f"{cast.to.name} != declared type {col.dtype.name}")
            narrowed.append(name)
        else:
            raise ContractCompositionError(
                f"{output.__name__}.{name}: incompatible types "
                f"{upcol.dtype.name} -> {col.dtype.name}")
        # --- nullability flow ---
        if upcol.nullable and not col.nullable:
            # legal only when declared: [NotNull] lineage (inherited_from
            # set and nullability narrowed) or an explicit cast.
            declared = (col.inherited_from is not None) or (name in cast_by_col)
            if not declared:
                raise ContractCompositionError(
                    f"{output.__name__}.{name}: narrows nullability without "
                    f"an explicit [NotNull] declaration")
            if name not in narrowed:
                narrowed.append(name)

    return EdgeReport(
        upstream="+".join(s.__name__ for s in inputs.values()),
        downstream=output.__name__,
        inherited=tuple(inherited),
        narrowed=tuple(narrowed),
        fresh=tuple(fresh),
    )


# ---------------------------------------------------------------------------
# Moment 3: worker
# ---------------------------------------------------------------------------

def validate_table(table, schema: type[S.Schema], *,
                   elide: frozenset[str] = frozenset(),
                   name: str = "<table>") -> None:
    """Validate physical data against its declared schema (worker moment).

    ``table`` is a :class:`repro_torch.data.tables.Table`. ``elide`` contains
    column names whose null-check was statically discharged by the planner
    (:func:`provable_postconditions`) and can be skipped.
    """
    cols = schema.columns()
    missing = set(cols) - set(table.column_names())
    if missing:
        raise ContractRuntimeError(
            f"{name}: missing columns {sorted(missing)} required by "
            f"{schema.__name__}")
    for cname, col in cols.items():
        physical = table.logical_dtype(cname)
        if physical != col.dtype.name:
            raise ContractRuntimeError(
                f"{name}.{cname}: physical dtype {physical} != declared "
                f"{col.dtype.name}")
        if not col.nullable and cname not in elide:
            if table.has_nulls(cname):
                raise ContractRuntimeError(
                    f"{name}.{cname}: contract declares NOT NULL but data "
                    f"contains nulls (paper §3.1: unexpected nulls are "
                    f"contract violations)")


# ---------------------------------------------------------------------------
# "Dafny-style" static discharge (Appendix A)
# ---------------------------------------------------------------------------

def provable_postconditions(
    inputs: Mapping[str, type[S.Schema]],
    output: type[S.Schema],
    *,
    inspectable: bool,
    null_preserving: bool,
) -> frozenset[str]:
    """Columns of ``output`` whose NOT-NULL check is statically provable.

    Per Appendix A, the worker-side null check for an output column can be
    elided when (1) the output schema is trusted/defined, (2) the node's
    transformation language is inspectable (e.g. declarative select), and
    (3) the transformation provably maintains nullability — here summarised
    by ``null_preserving`` (our declarative ``Table.select`` without outer
    joins is null-preserving for inherited columns).
    """
    if not (inspectable and null_preserving):
        return frozenset()
    provable = set()
    for name, col in output.columns().items():
        if col.nullable:
            continue
        src = _resolve_upstream(col, inputs)
        if src is None:
            continue  # fresh column: must be checked physically
        _, upcol = src
        if not upcol.nullable:
            # upstream guarantees not-null, transformation preserves it.
            provable.add(name)
    return frozenset(provable)
