"""Pipeline DAGs: ``Table(s) -> Table`` nodes with typed contracts.

Bauplan restricts DAG nodes to the signature *Table(s) -> Table* (paper
§3.3) but is agnostic about what happens inside. We model two node kinds,
mirroring the paper's SQL/Python split:

- :class:`PythonNode` — an *imperative* transformation (arbitrary Python
  over :class:`~repro_torch.data.tables.Table`). Not inspectable: casts must be
  declared, and no worker-side checks can be statically elided.
- :class:`DeclarativeNode` — a *declarative* transformation (select /
  filter / join expression trees). Inspectable: the planner extracts
  casts from ``arrow_cast`` markers and determines null-preservation,
  enabling Appendix-A-style static discharge of runtime checks.

The paper's authoring syntax is preserved: a node's parameters are
annotated with input schemas and default to the upstream table name, the
return annotation is the output schema (Listing 5)::

    @pipeline.node()
    def child_table(df: ParentSchema = "parent_table") -> ChildSchema:
        ...
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core import schema as S
from repro_torch.core.contracts import CastDecl
from repro_torch.core.errors import PlanError
from repro_torch.data.tables import Expr, Table

__all__ = ["Node", "PythonNode", "DeclarativeNode", "Pipeline"]


def _code_fingerprint(co) -> str:
    """Hash a code object: bytecode + data consts + referenced names,
    recursing into nested code objects (lambdas, comprehensions)."""
    h = hashlib.sha256()

    def fold(c):
        h.update(c.co_code)
        consts = tuple(x for x in c.co_consts if not hasattr(x, "co_code"))
        h.update(repr((consts, c.co_names)).encode())
        for x in c.co_consts:
            if hasattr(x, "co_code"):
                fold(x)

    fold(co)
    return h.hexdigest()[:16]


def _names_read(co) -> set[str]:
    """All global names a code object reads, including inside nested
    code objects (a lambda's global read is still this function's)."""
    names = set(co.co_names)
    for c in co.co_consts:
        if hasattr(c, "co_code"):
            names |= _names_read(c)
    return names


def _fingerprint_function(fn, seen: set[int]) -> str | None:
    """Fingerprint a Python function as cache-key material: its code
    (recursively, see :func:`_code_fingerprint`), its captured closure
    cells, and every module-global *data* value its bytecode reads —
    referenced helper functions are fingerprinted the same way, so a
    constant or global change inside a helper moves the key too.
    ``None`` = not faithfully fingerprintable (caller must not cache).
    """
    if id(fn) in seen:                 # recursion cycle: code already
        return f"fnrec:{fn.__qualname__}"  # folded at first visit
    seen.add(id(fn))
    parts = [f"code={_code_fingerprint(fn.__code__)}"]
    if fn.__closure__:
        for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                v = cell.cell_contents
            except ValueError:          # pragma: no cover - empty cell
                parts.append(f"{var}=<unbound>")
                continue
            fp = _fingerprint_value(v, seen)
            if fp is None:
                return None
            parts.append(f"{var}={fp}")
    for name in sorted(_names_read(fn.__code__)):
        if name not in fn.__globals__:
            continue                    # builtin or pure attribute name
        v = fn.__globals__[name]
        if isinstance(v, type) or inspect.ismodule(v):
            continue                    # import-stable (DESIGN.md §8)
        fp = _fingerprint_value(v, seen)
        if fp is None:
            return None                 # mutable global data read
        parts.append(f"g:{name}={fp}")
    return "fn(" + ",".join(parts) + ")"


def _fingerprint_value(v: Any, seen: set[int] | None = None) -> str | None:
    """A stable fingerprint for a runtime value, or None.

    Only values whose ``repr`` is total and value-determined qualify:
    scalars, strings, and containers thereof. Python functions are
    fingerprinted structurally (:func:`_fingerprint_function`); C-level
    builtins by qualified name. Everything else — arbitrary objects
    (default id-based repr), numpy arrays (repr truncates), open
    handles — returns None: such values can mutate between runs without
    changing any printable identity, so a cache key built from them
    could serve stale outputs.
    """
    seen = seen if seen is not None else set()
    if v is None or isinstance(v, (bool, int, float, complex,
                                   str, bytes)):
        return repr(v)
    if isinstance(v, (tuple, list)):
        parts = [_fingerprint_value(x, seen) for x in v]
        if any(p is None for p in parts):
            return None
        return f"{type(v).__name__}({','.join(parts)})"
    if isinstance(v, (set, frozenset)):
        parts = [_fingerprint_value(x, seen) for x in v]
        if any(p is None for p in parts):
            return None
        return f"{type(v).__name__}({','.join(sorted(parts))})"
    if isinstance(v, dict):
        items = [(_fingerprint_value(k, seen), _fingerprint_value(x, seen))
                 for k, x in v.items()]
        if any(k is None or x is None for k, x in items):
            return None
        return "dict(" + ",".join(f"{k}:{x}"
                                  for k, x in sorted(items)) + ")"
    if inspect.isfunction(v):
        return _fingerprint_function(v, seen)
    if inspect.isbuiltin(v):            # C function: code is the binary
        return f"builtin:{getattr(v, '__module__', '?')}.{v.__qualname__}"
    return None


@dataclasses.dataclass(frozen=True)
class Node:
    """Common node metadata."""

    name: str                           # output table name
    inputs: Mapping[str, str]           # param name -> upstream table name
    input_schemas: Mapping[str, type[S.Schema]]
    output_schema: type[S.Schema]
    casts: tuple[CastDecl, ...] = ()
    inspectable: bool = False
    null_preserving: bool = False

    def run(self, tables: Mapping[str, Table]) -> Table:
        raise NotImplementedError

    def source(self) -> str:
        return f"<node {self.name}>"

    def cache_material(self) -> str | None:
        """Static half of the engine's content-addressed cache key: the
        transformation source, the declared output contract, and the
        declared casts. The dynamic half (input snapshot keys) is bound
        by :func:`repro_torch.core.engine.cache_key` at execution time, which
        also folds in the active execution-backend name (DESIGN.md §9)
        — backend choice is runtime state, not node identity, so it is
        deliberately absent here. The node *name* is likewise excluded
        — two nodes computing the same function over the same inputs
        share one cache entry.
        ``None`` marks the node as not content-addressable (the engine
        always executes it)."""
        casts = ";".join(f"{c.column}->{c.to.name}" for c in self.casts)
        return (f"{self.source()}|"
                f"{self.output_schema.fingerprint()}|{casts}")


@dataclasses.dataclass(frozen=True)
class PythonNode(Node):
    fn: Callable[..., Table] = None  # type: ignore[assignment]

    def run(self, tables: Mapping[str, Table]) -> Table:
        kwargs = {param: tables[t] for param, t in self.inputs.items()}
        out = self.fn(**kwargs)
        if not isinstance(out, Table):
            raise PlanError(
                f"node {self.name!r} must return a Table, got "
                f"{type(out).__name__} (DAG nodes are Table(s) -> Table)")
        return out

    def source(self) -> str:
        try:
            return inspect.getsource(self.fn)
        except (OSError, TypeError):
            return f"<python {self.name}>"

    def cache_material(self) -> str | None:
        # Source text alone under-identifies a Python function: two
        # closures over different values share identical text, and
        # inspect.getsource can fail entirely (exec'd/REPL-defined
        # functions), collapsing source() to a name-only fallback.
        # _fingerprint_function folds in the recursive bytecode+consts
        # fingerprint, the captured closure cells, and every
        # module-global data value the bytecode (incl. nested lambdas
        # and referenced helper functions) reads. Anything that cannot
        # be fingerprinted faithfully — arbitrary objects, numpy arrays
        # (whose repr truncates) — makes the node UNCACHEABLE rather
        # than risking a stale hit; modules and classes are assumed
        # import-stable (DESIGN.md §8).
        if self.fn is None:     # pragma: no cover - defensive
            return None
        fp = _fingerprint_function(self.fn, set())
        if fp is None:
            return None
        return super().cache_material() + "|" + fp


@dataclasses.dataclass(frozen=True)
class DeclarativeNode(Node):
    """select(exprs) [after optional filter / join(s)] — inspectable.

    Joins form a left-deep chain: ``joins`` lists ``(table, on)`` pairs
    folded in order onto the first input (``join_with``/``join_on`` are
    the single-join sugar, normalized into ``joins``). The body is a
    fixed join -> filter -> group-by -> select shape, which is exactly
    what lowers to the logical IR (:meth:`logical_tree`) — the
    optimizer rewrites the IR, never this node. ``group_keys`` +
    ``agg_specs`` (normalized ``(fn, value, out)`` triples; see
    ``repro_torch.data.tables.resolve_agg_specs``) lower to the ``Aggregate``
    op; when set, ``exprs`` project over the aggregate's output."""

    exprs: tuple[Expr, ...] = ()
    filter_expr: Expr | None = None
    join_with: str | None = None        # second input table name
    join_on: tuple[str, ...] = ()
    joins: tuple[tuple[str, tuple[str, ...]], ...] = ()
    join_how: str = "inner"
    group_keys: tuple[str, ...] = ()
    agg_specs: tuple[tuple[str, str, str], ...] = ()

    def __post_init__(self):
        if not self.joins and self.join_with is not None:
            object.__setattr__(
                self, "joins",
                ((self.join_with, tuple(self.join_on)),))
        # extract casts from arrow_cast markers; mark inspectable.
        # Membership-checked so the extraction is idempotent —
        # dataclasses.replace() re-runs __post_init__ on already-
        # extracted casts.
        casts = list(self.casts)
        for e in self.exprs:
            target = getattr(e, "cast_target", None)
            if target is not None:
                decl = CastDecl(e.output_name(), S.as_dtype(target))
                if decl not in casts:
                    casts.append(decl)
        object.__setattr__(self, "casts", tuple(casts))
        object.__setattr__(self, "inspectable", True)
        # select/filter/inner-join cannot introduce nulls into inherited
        # columns -> null-preserving (Appendix A condition (2)+(3)).
        # This claim assumes SQL join semantics: Table.join drops
        # null-keyed rows (NULL matches nothing), so an inner join only
        # ever *selects* existing rows. tests/test_engine.py keeps the
        # elided checks honest against the physical implementation.
        # A LEFT join manufactures NULLs in unmatched right columns, so
        # it does not preserve. Aggregation likewise manufactures NULLs
        # (an all-NULL group's SUM/MIN/MAX/MEAN is NULL), so a grouped
        # node never preserves.
        object.__setattr__(self, "null_preserving",
                           self.join_how == "inner"
                           and not self.agg_specs)

    def logical_tree(self):
        """Lower to the logical IR
        (join(s) -> filter -> aggregate -> select)."""
        from repro_torch.core import logical as L
        (_, first_table), *_rest = list(self.inputs.items())
        op: "L.LogicalOp" = L.Scan(first_table)
        for t, on in self.joins:
            op = L.Join(op, L.Scan(t), on=tuple(on), how=self.join_how)
        if self.filter_expr is not None:
            op = L.Filter(op, self.filter_expr)
        if self.agg_specs:
            op = L.Aggregate(op, keys=tuple(self.group_keys),
                             specs=tuple(self.agg_specs))
        if self.exprs:
            op = L.Project(op, tuple(self.exprs))
        return op

    def run(self, tables: Mapping[str, Table]) -> Table:
        # single execution path: the node body IS its logical tree, so
        # direct runs and engine runs (which may execute a rewritten
        # tree instead) can never drift semantically.
        return self.logical_tree().execute(tables)

    def source(self) -> str:
        # describe() (structural, alias-surviving) rather than
        # output_name(): `lit(0.25) AS x` and `lit(0.5) AS x` must not
        # collide in the content-addressed cache.
        parts = [f"select {[e.describe() for e in self.exprs]}"]
        if self.agg_specs:
            specs = [f"{fn}({value})->{out}"
                     for fn, value, out in self.agg_specs]
            parts.append(
                f"group by {list(self.group_keys)} agg {specs}")
        if self.filter_expr is not None:
            parts.append(f"filter {self.filter_expr.describe()}")
        for t, on in self.joins:
            if self.join_how == "inner":
                parts.append(f"join {t} on {list(on)}")
            else:
                parts.append(f"join[{self.join_how}] {t} on {list(on)}")
        # the node name is intentionally absent (Pipeline.code_hash mixes
        # it in separately): cache keys identify the *function*, not the
        # output table it happens to be bound to.
        return f"<declarative: {'; '.join(parts)}>"

    def cache_material(self) -> str | None:
        # source() describes exprs structurally — but only expressions
        # built through the library constructors (col/lit/operators/
        # arrow_cast) carry a faithful structural description. A
        # hand-rolled Expr(fn, name) is opaque: two different fns under
        # one name would collide, so such nodes are uncacheable.
        exprs = list(self.exprs)
        if self.filter_expr is not None:
            exprs.append(self.filter_expr)
        if any(not getattr(e, "_structural", False) for e in exprs):
            return None
        return super().cache_material()


class Pipeline:
    """A named collection of nodes forming a DAG."""

    def __init__(self, name: str):
        self.name = name
        self._nodes: dict[str, Node] = {}
        self._source_schemas: dict[str, type[S.Schema]] = {}

    # -- source tables (exist in the lake already) ----------------------
    def source(self, table: str, schema: type[S.Schema]) -> None:
        self._source_schemas[table] = schema

    # -- authoring API ---------------------------------------------------
    def node(self, *, name: str | None = None,
             casts: Sequence[CastDecl] = ()) -> Callable:
        """Decorator for imperative (Python) nodes, paper Listing 5 style."""

        def deco(fn: Callable[..., Table]) -> Callable[..., Table]:
            sig = inspect.signature(fn)
            hints = dict(fn.__annotations__)
            if any(isinstance(v, str) for v in hints.values()):
                # PEP 563 (`from __future__ import annotations`): resolve
                # string annotations against the caller's frame so Schema
                # classes defined in function scope still work.
                frame = inspect.currentframe().f_back
                ns = dict(fn.__globals__)
                if frame is not None:
                    ns.update(frame.f_locals)
                hints = {k: (eval(v, ns) if isinstance(v, str) else v)  # noqa: S307
                         for k, v in hints.items()}
            inputs: dict[str, str] = {}
            input_schemas: dict[str, type[S.Schema]] = {}
            for param in sig.parameters.values():
                ann = hints.get(param.name)
                if ann is None or not (isinstance(ann, type)
                                       and issubclass(ann, S.Schema)):
                    raise PlanError(
                        f"node {fn.__name__!r}: parameter {param.name!r} "
                        f"must be annotated with a Schema")
                upstream = (param.default
                            if param.default is not inspect.Parameter.empty
                            else param.name)
                if callable(upstream) and hasattr(upstream, "_node_name_"):
                    upstream = upstream._node_name_
                inputs[param.name] = str(upstream)
                input_schemas[param.name] = ann
            ret = hints.get("return")
            if ret is None or not (isinstance(ret, type)
                                   and issubclass(ret, S.Schema)):
                raise PlanError(
                    f"node {fn.__name__!r}: missing Schema return annotation")
            node = PythonNode(
                name=name or fn.__name__, inputs=inputs,
                input_schemas=input_schemas, output_schema=ret,
                casts=tuple(casts), fn=fn)
            self.add(node)
            fn._node_name_ = node.name  # allow `= other_fn` defaults
            return fn
        return deco

    def sql(self, *, name: str, inputs: Mapping[str, str],
            input_schemas: Mapping[str, type[S.Schema]],
            output_schema: type[S.Schema],
            exprs: Sequence[Expr] = (),
            filter_expr: Expr | None = None,
            join_with: str | None = None,
            join_on: Sequence[str] = (),
            joins: Sequence[tuple[str, Sequence[str]]] = (),
            join_how: str = "inner",
            group_keys: Sequence[str] = (),
            agg_specs: Sequence[tuple] = ()) -> DeclarativeNode:
        """Register a declarative node (paper Listing 4's annotated SQL).

        ``joins`` is the multi-join form (a left-deep ``(table, on)``
        chain); ``join_with``/``join_on`` remain the single-join sugar.
        ``group_keys``/``agg_specs`` express GROUP BY: specs are
        ``(fn, value)`` or ``(fn, value, out)`` tuples, normalized here
        through the same :func:`~repro_torch.data.tables.resolve_agg_specs`
        as the eager ``Table.group_by().agg()`` path, so both spell
        identical output columns.
        """
        from repro_torch.data.tables import resolve_agg_specs
        if joins and (join_with is not None or join_on):
            raise PlanError(
                f"node {name!r}: pass either the single-join sugar "
                f"(join_with/join_on) or the joins chain, not both — "
                f"the sugar is normalized into joins, so mixing them "
                f"would silently drop one spelling")
        if agg_specs and not group_keys:
            raise PlanError(
                f"node {name!r}: agg_specs requires group_keys")
        node = DeclarativeNode(
            name=name, inputs=dict(inputs),
            input_schemas=dict(input_schemas), output_schema=output_schema,
            exprs=tuple(exprs), filter_expr=filter_expr,
            join_with=join_with, join_on=tuple(join_on),
            joins=tuple((t, tuple(on)) for t, on in joins),
            join_how=join_how, group_keys=tuple(group_keys),
            agg_specs=(resolve_agg_specs(group_keys, agg_specs)
                       if agg_specs else ()))
        self.add(node)
        return node

    def sql_query(self, *, name: str, query: str):
        """Not ported yet: SQL nodes need ``repro_torch.sql``, which
        comes with the slice that ports the SQL front door."""
        raise NotImplementedError(
            "Pipeline.sql_query is not ported yet: it waits for the slice "
            "that ports repro.sql; build the node with Pipeline.sql")

    def add(self, node: Node) -> None:
        if node.name in self._nodes or node.name in self._source_schemas:
            raise PlanError(f"duplicate table/node name {node.name!r}")
        self._nodes[node.name] = node

    # -- structure --------------------------------------------------------
    @property
    def nodes(self) -> Mapping[str, Node]:
        return dict(self._nodes)

    @property
    def source_schemas(self) -> Mapping[str, type[S.Schema]]:
        return dict(self._source_schemas)

    def topo_order(self) -> list[Node]:
        """Topologically sorted nodes; raises PlanError on cycle/missing."""
        order: list[Node] = []
        state: dict[str, int] = {}  # 0=unvisited 1=visiting 2=done

        def visit(name: str, chain: tuple[str, ...]) -> None:
            if name in self._source_schemas:
                return
            node = self._nodes.get(name)
            if node is None:
                raise PlanError(
                    f"node {chain[-1]!r} reads table {name!r} which is "
                    f"neither a node output nor a declared source")
            st = state.get(name, 0)
            if st == 1:
                raise PlanError(
                    f"cycle detected: {' -> '.join(chain + (name,))}")
            if st == 2:
                return
            state[name] = 1
            for upstream in node.inputs.values():
                visit(upstream, chain + (name,))
            state[name] = 2
            order.append(node)

        for name in self._nodes:
            visit(name, ())
        return order

    def code_hash(self) -> str:
        h = hashlib.sha256()
        for node in sorted(self._nodes.values(), key=lambda n: n.name):
            h.update(node.name.encode())
            h.update(node.source().encode())
            h.update(node.output_schema.fingerprint().encode())
        return h.hexdigest()[:16]
