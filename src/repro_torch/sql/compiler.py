"""AST -> logical-IR compiler for the SQL front door (DESIGN.md §13).

``compile_query`` turns a parsed :class:`repro_torch.sql.ast.Query` plus the
input table contracts into a :class:`SqlNode` — a
:class:`~repro_torch.core.dag.DeclarativeNode` carrying a pre-built logical
tree — and a *synthesized* output :class:`~repro_torch.core.schema.Schema`
whose dtypes/nullability are inferred (:mod:`repro_torch.sql.infer`), with
explicit lineage on every pass-through column so contract composition
(:func:`repro_torch.core.contracts.check_node`) and Appendix-A elision see
exactly where each output column comes from.

Name resolution uses *scopes*: scope 0 is the FROM table, scope k the
k-th joined table. After a join the visible namespace is the union of
all scope columns with join keys merged onto the left spelling; when a
right-side column would collide with an earlier name, referenced
columns are renamed ``__q{k}_{col}`` behind a rename Project (internal
names only — they can never appear in an output contract) and
unreferenced collisions are dropped. An unqualified column appearing in
several scopes is accepted only when every occurrence is ON-equated
into one equivalence class (the join key merged them anyway); anything
else is ambiguous and must be qualified.

The compiled tree is canonical: two spellings of the same query (case,
whitespace, alias names that do not reach the output) produce the same
tree, the same ``describe()``, and therefore the same content-addressed
cache key. The query text itself is carried on the node for EXPLAIN
output but is *never* cache material.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping

from repro_torch.core import logical as L
from repro_torch.core import schema as S
from repro_torch.core.dag import DeclarativeNode
from repro_torch.data.tables import Expr, col, lit
from repro_torch.sql import ast as A
from repro_torch.sql.errors import SqlCompileError, unknown_name
from repro_torch.sql.infer import (ColInfo, agg_result, dummy_table,
                             infer_expr, namespace_of)
from repro_torch.sql.parser import parse

__all__ = ["SqlNode", "CompiledQuery", "compile_query"]


@dataclasses.dataclass(frozen=True)
class SqlNode(DeclarativeNode):
    """A declarative node compiled from SQL text.

    The body IS the compiled logical tree (``tree``); the inherited
    declarative fields (joins/filter/group/exprs) are populated
    faithfully so the planner's inspectability machinery
    (null-preservation, cast extraction, aggregate-output pruning)
    keeps working unchanged. ``query`` is display metadata only —
    ``source()`` describes the *tree*, so two spellings of one query
    share cache entries and a comment change can never force a rerun.
    """

    tree: Any = None
    query: str = ""

    def logical_tree(self):
        return self.tree

    def run(self, tables):
        return self.tree.execute(tables)

    def source(self) -> str:
        return f"<sql: {self.tree.describe()}>"


@dataclasses.dataclass(frozen=True)
class CompiledQuery:
    node: SqlNode
    output_schema: type[S.Schema]
    tables: tuple[str, ...]      # referenced input tables, FROM first


@dataclasses.dataclass(frozen=True)
class _Scope:
    index: int
    binding: str                 # alias, or the table name
    table: str
    schema: type[S.Schema]


def _walk(e: Any) -> Iterator[Any]:
    yield e
    if isinstance(e, A.BinOp):
        yield from _walk(e.left)
        yield from _walk(e.right)
    elif isinstance(e, (A.UnaryOp, A.IsNull)):
        yield from _walk(e.operand)
    elif isinstance(e, A.AggCall):
        yield from _walk(e.arg)


class _UnionFind:
    def __init__(self):
        self._parent: dict[Any, Any] = {}

    def find(self, x):
        p = self._parent.setdefault(x, x)
        if p != x:
            p = self._parent[x] = self.find(p)
        return p

    def union(self, a, b):
        self._parent[self.find(a)] = self.find(b)


_BIN_COMPILE: dict[str, Callable[[Expr, Expr], Expr]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
}


class _Compiler:
    def __init__(self, query_text: str, q: A.Query,
                 schemas: Mapping[str, type[S.Schema]], context: str):
        self.text = query_text
        self.q = q
        self.schemas = schemas
        self.context = context
        self.scopes: list[_Scope] = []
        self.bindings: dict[str, _Scope] = {}
        # output-name namespace after all joins:
        #   ns[out] = (owning scope index, source column)
        #   phys[(scope, src)] = out   (merged keys point at the left)
        self.ns: dict[str, tuple[int, str]] = {}
        self.phys: dict[tuple[int, str], str] = {}
        self.ns_info: dict[str, ColInfo] = {}   # out -> (dtype, nullable)
        self.referenced: dict[int, set[str]] = {}
        self.resolved: dict[A.ColumnRef, tuple[int, str]] = {}
        self.on_pairs: list[list[tuple[tuple[int, str],
                                       tuple[int, str]]]] = []
        self.equiv = _UnionFind()

    def err(self, msg: str) -> SqlCompileError:
        return SqlCompileError(f"{msg} at {self.context}")

    # -- scopes and resolution ------------------------------------------
    def build_scopes(self):
        refs = [self.q.from_table] + [j.table for j in self.q.joins]
        for i, tref in enumerate(refs):
            if tref.name not in self.schemas:
                raise unknown_name(
                    "table", tref.name, list(self.schemas),
                    self.context, list_known=True)
            if tref.binding in self.bindings:
                raise self.err(
                    f"duplicate table alias {tref.binding!r} "
                    f"(alias a self-join explicitly)")
            sc = _Scope(i, tref.binding, tref.name,
                        self.schemas[tref.name])
            self.scopes.append(sc)
            self.bindings[tref.binding] = sc
            self.referenced[i] = set()

    def _candidates(self, name: str) -> list[tuple[int, str]]:
        return [(sc.index, name) for sc in self.scopes
                if name in sc.schema.columns()]

    def resolve(self, ref: A.ColumnRef) -> tuple[int, str]:
        """Resolve a column reference to (scope index, source column)."""
        hit = self.resolved.get(ref)
        if hit is not None:
            return hit
        if ref.table is not None:
            sc = self.bindings.get(ref.table)
            if sc is None:
                raise unknown_name("table", ref.table,
                                   list(self.bindings), self.context)
            if ref.name not in sc.schema.columns():
                raise unknown_name(
                    "column", ref.name, list(sc.schema.columns()),
                    self.context, where=f" in table {sc.table!r}")
            out = (sc.index, ref.name)
        else:
            cands = self._candidates(ref.name)
            if not cands:
                everything = {c for sc in self.scopes
                              for c in sc.schema.columns()}
                raise unknown_name("column", ref.name,
                                   sorted(everything), self.context)
            if len(cands) > 1:
                roots = {self.equiv.find(c) for c in cands}
                if len(roots) > 1:
                    tables = [self.scopes[s].binding for s, _ in cands]
                    raise self.err(
                        f"ambiguous column {ref.name!r} (present in "
                        f"{tables}; qualify it)")
            out = cands[0]
        self.resolved[ref] = out
        self.referenced[out[0]].add(out[1])
        return out

    def orient_joins(self):
        """Resolve and orient every ON equality: one side must belong
        to the newly joined table, the other to an earlier scope."""
        for k, join in enumerate(self.q.joins, start=1):
            pairs: list[tuple[tuple[int, str], tuple[int, str]]] = []
            for a, b in join.on:
                ca = self._on_candidates(a, k)
                cb = self._on_candidates(b, k)
                pick = None
                for x in ca:
                    for y in cb:
                        if x[0] == k and y[0] < k:
                            pick = ((y, x), (x, y))   # (left,right),(a,b)
                        elif y[0] == k and x[0] < k:
                            pick = ((x, y), (x, y))
                        if pick:
                            break
                    if pick:
                        break
                if pick is None:
                    raise self.err(
                        f"join condition "
                        f"{a.display()} = {b.display()} must relate "
                        f"table {join.table.binding!r} to an earlier "
                        f"table")
                (left, right), (res_a, res_b) = pick
                self.resolved.setdefault(a, res_a)
                self.resolved.setdefault(b, res_b)
                pairs.append((left, right))
                self.referenced[left[0]].add(left[1])
                self.referenced[right[0]].add(right[1])
                self.equiv.union(left, right)
            self.on_pairs.append(pairs)

    def _on_candidates(self, ref: A.ColumnRef,
                       k: int) -> list[tuple[int, str]]:
        if ref.table is not None:
            sc = self.bindings.get(ref.table)
            if sc is None:
                raise unknown_name("table", ref.table,
                                   list(self.bindings), self.context)
            if sc.index > k:
                raise self.err(
                    f"join condition references {ref.display()!r} "
                    f"before table {sc.binding!r} is joined")
            if ref.name not in sc.schema.columns():
                raise unknown_name(
                    "column", ref.name, list(sc.schema.columns()),
                    self.context, where=f" in table {sc.table!r}")
            return [(sc.index, ref.name)]
        cands = [(s, c) for s, c in self._candidates(ref.name)
                 if s <= k]
        if not cands:
            everything = {c for sc in self.scopes
                          for c in sc.schema.columns()}
            raise unknown_name("column", ref.name, sorted(everything),
                               self.context)
        return cands

    def collect_references(self):
        """Resolve every column reference up front so namespace
        assignment knows which right-side columns must survive."""
        exprs: list[Any] = []
        for item in self.q.items:
            if isinstance(item.expr, A.Star):
                star = item.expr
                if star.table is None:
                    for sc in self.scopes:
                        self.referenced[sc.index].update(
                            sc.schema.columns())
                else:
                    sc = self.bindings.get(star.table)
                    if sc is None:
                        raise unknown_name(
                            "table", star.table, list(self.bindings),
                            self.context)
                    self.referenced[sc.index].update(
                        sc.schema.columns())
            else:
                exprs.append(item.expr)
        if self.q.where is not None:
            exprs.append(self.q.where)
        exprs.extend(self.q.group_by)
        for e in exprs:
            for node in _walk(e):
                if isinstance(node, A.ColumnRef):
                    self.resolve(node)

    # -- namespace assignment and join-tree construction -----------------
    def build_join_tree(self) -> L.LogicalOp:
        sc0 = self.scopes[0]
        for c, column in sc0.schema.columns().items():
            self.ns[c] = (0, c)
            self.phys[(0, c)] = c
            self.ns_info[c] = (column.dtype, column.nullable)
        op: L.LogicalOp = L.Scan(sc0.table)

        for k, join in enumerate(self.q.joins, start=1):
            sc = self.scopes[k]
            pairs = self.on_pairs[k - 1]
            key_map: dict[str, str] = {}     # right src -> output name
            on_names: list[str] = []
            for (ls, lc), (_, rc) in pairs:
                left_out = self.phys[(ls, lc)]
                if rc in key_map or left_out in key_map.values():
                    raise self.err(
                        f"duplicate join key in ON clause for table "
                        f"{sc.binding!r}")
                key_map[rc] = left_out
                on_names.append(left_out)

            cols = sc.schema.columns()
            keep = [c for c in cols
                    if c in key_map or c in self.referenced[k]]
            renames = {c: key_map[c] for c in key_map
                       if key_map[c] != c}
            collisions = [c for c in keep
                          if c not in key_map and c in self.ns]
            need_project = bool(renames) or bool(collisions)

            right: L.LogicalOp = L.Scan(sc.table)
            if need_project:
                rexprs: list[Expr] = []
                taken = set(self.ns)
                for c in cols:
                    if c in key_map:
                        dst = key_map[c]
                        rexprs.append(col(c).alias(dst))
                        self.phys[(k, c)] = dst
                        continue
                    if c not in self.referenced[k]:
                        continue             # unreferenced: dropped
                    dst = c
                    if dst in taken:
                        dst = f"__q{k}_{c}"
                        while dst in taken:
                            dst += "_"
                    taken.add(dst)
                    rexprs.append(col(c).alias(dst))
                    self.phys[(k, c)] = dst
                    self.ns[dst] = (k, c)
                    self.ns_info[dst] = (cols[c].dtype,
                                         cols[c].nullable
                                         or join.how == "left")
                right = L.Project(right, tuple(rexprs))
            else:
                for c, column in cols.items():
                    if c in key_map:         # same-named key: merged
                        self.phys[(k, c)] = key_map[c]
                        continue
                    self.phys[(k, c)] = c
                    self.ns[c] = (k, c)
                    self.ns_info[c] = (column.dtype,
                                       column.nullable
                                       or join.how == "left")
            op = L.Join(op, right, on=tuple(on_names), how=join.how)
        return op

    # -- scalar expression compilation ----------------------------------
    def compile_scalar(self, e: Any,
                       column: Callable[[A.ColumnRef], Expr],
                       agg: "Callable[[A.AggCall], Expr] | None" = None,
                       ) -> Expr:
        if isinstance(e, A.Literal):
            return lit(e.value)
        if isinstance(e, A.ColumnRef):
            return column(e)
        if isinstance(e, A.BinOp):
            return _BIN_COMPILE[e.op](
                self.compile_scalar(e.left, column, agg),
                self.compile_scalar(e.right, column, agg))
        if isinstance(e, A.UnaryOp):
            operand = self.compile_scalar(e.operand, column, agg)
            return ~operand if e.op == "NOT" else -operand
        if isinstance(e, A.IsNull):
            operand = self.compile_scalar(e.operand, column, agg)
            nn = operand.is_not_null()
            return nn if e.negated else ~nn
        if isinstance(e, A.AggCall):
            if agg is None:
                raise self.err(
                    f"aggregate {e.fn.upper()} is not allowed here "
                    f"(only in the select list of a GROUP BY query)")
            return agg(e)
        if isinstance(e, A.Star):
            raise self.err("'*' is not a scalar expression")
        raise self.err(f"unsupported expression {e!r}")   # pragma: no cover

    def ns_column(self, ref: A.ColumnRef) -> Expr:
        s, c = self.resolve(ref)
        return col(self.phys[(s, c)])

    # -- the main compile ------------------------------------------------
    def compile(self, *, name: str,
                schema_name: str | None) -> CompiledQuery:
        q = self.q
        self.build_scopes()
        self.orient_joins()
        self.collect_references()
        op = self.build_join_tree()

        filter_expr: Expr | None = None
        if q.where is not None:
            if any(isinstance(n, A.AggCall) for n in _walk(q.where)):
                raise self.err("aggregates are not allowed in WHERE")
            filter_expr = self.compile_scalar(q.where, self.ns_column)
            op = L.Filter(op, filter_expr)

        agg_calls = [n for item in q.items
                     if not isinstance(item.expr, A.Star)
                     for n in _walk(item.expr)
                     if isinstance(n, A.AggCall)]
        for call in agg_calls:
            if any(isinstance(n, A.AggCall) for n in _walk(call.arg)):
                raise self.err(
                    f"nested aggregate in {call.fn.upper()}(...)")

        group_keys: tuple[str, ...] = ()
        agg_specs: tuple[tuple[str, str, str], ...] = ()
        if q.group_by:
            if not agg_calls:
                raise self.err(
                    "GROUP BY requires at least one aggregate "
                    "(SUM/COUNT/MIN/MAX/MEAN) in the select list")
            op, group_keys, agg_specs, out_ns, item_exprs = \
                self._compile_grouped(op, agg_calls)
        elif agg_calls:
            raise self.err(
                f"aggregate {agg_calls[0].fn.upper()} requires "
                f"GROUP BY")
        else:
            out_ns, item_exprs = self._compile_plain()

        exprs = tuple(e for e, _ in item_exprs)
        op = L.Project(op, exprs)

        order_keys = self._order_keys(item_exprs)
        if order_keys:
            op = L.Sort(op, keys=order_keys)
        if q.limit is not None:
            op = L.Limit(op, q.limit)

        from repro_torch.obs import get_recorder
        rec = get_recorder()
        if rec.enabled:
            # contract inference = dummy evaluation against the real
            # kernels — the one compile stage that executes anything.
            with rec.span("infer", items=len(item_exprs)):
                output_schema = self._synthesize_schema(
                    schema_name or f"{name}_schema", out_ns, item_exprs)
        else:
            output_schema = self._synthesize_schema(
                schema_name or f"{name}_schema", out_ns, item_exprs)
        tables = tuple(q.table_names())
        node = SqlNode(
            name=name,
            inputs={t: t for t in tables},
            input_schemas={t: self.schemas[t] for t in tables},
            output_schema=output_schema,
            exprs=exprs,
            filter_expr=filter_expr,
            joins=tuple(
                (self.scopes[k].table,
                 tuple(self.phys[(ls, lc)]
                       for (ls, lc), _ in self.on_pairs[k - 1]))
                for k in range(1, len(self.scopes))),
            join_how=("left" if any(j.how == "left" for j in q.joins)
                      else "inner"),
            group_keys=group_keys,
            agg_specs=agg_specs,
            tree=op,
            query=self.text)
        return CompiledQuery(node=node, output_schema=output_schema,
                             tables=tables)

    # -- plain (no GROUP BY) select list --------------------------------
    def _item_name(self, item: A.SelectItem, idx: int) -> str:
        if item.alias is not None:
            if item.alias.startswith("_"):
                raise self.err(
                    f"output column {item.alias!r} must not start "
                    f"with '_'")
            return item.alias
        if isinstance(item.expr, A.ColumnRef):
            return item.expr.name
        return f"col{idx}"

    def _compile_plain(self):
        """Returns (pre-projection namespace for inference,
        [(final Expr, origin (scope, src) | None), ...] in select
        order — with output names already applied via alias)."""
        items: list[tuple[Expr, tuple[int, str] | None]] = []
        names: list[str] = []
        for idx, item in enumerate(self.q.items):
            if isinstance(item.expr, A.Star):
                items.extend(self._expand_star(item.expr, names))
                continue
            out = self._item_name(item, idx)
            if isinstance(item.expr, A.ColumnRef):
                s, c = self.resolve(item.expr)
                phys = self.phys[(s, c)]
                origin = self.ns[phys]
                items.append((col(phys).alias(out), origin))
            else:
                e = self.compile_scalar(item.expr, self.ns_column)
                items.append((e.alias(out), None))
            names.append(out)
        self._check_dup(names)
        return dict(self.ns_info), items

    def _expand_star(self, star: A.Star, names: list[str]):
        out: list[tuple[Expr, tuple[int, str] | None]] = []
        if star.table is None:
            # bare *: the whole namespace, scope order, merged keys once
            for phys, (s, c) in self.ns.items():
                out.append((col(phys).alias(c), (s, c)))
                names.append(c)
        else:
            sc = self.bindings[star.table]
            for c in sc.schema.columns():
                phys = self.phys[(sc.index, c)]
                origin = self.ns[phys]
                out.append((col(phys).alias(c), origin))
                names.append(c)
        return out

    def _check_dup(self, names: list[str]):
        seen: set[str] = set()
        for n in names:
            if n in seen:
                raise self.err(
                    f"duplicate output column {n!r} in select list "
                    f"(alias or qualify it)")
            seen.add(n)

    # -- GROUP BY --------------------------------------------------------
    def _compile_grouped(self, op: L.LogicalOp,
                         agg_calls: list[A.AggCall]):
        q = self.q
        keys: list[str] = []
        key_origin: dict[str, tuple[int, str]] = {}
        for ref in q.group_by:
            s, c = self.resolve(ref)
            phys = self.phys[(s, c)]
            if phys not in keys:
                keys.append(phys)
                key_origin[phys] = self.ns[phys]

        # one spec per distinct (fn, structural arg) call
        calls: list[dict] = []
        by_key: dict[tuple[str, str], dict] = {}
        computed = 0
        for call in agg_calls:
            arg = self.compile_scalar(call.arg, self.ns_column)
            ck = (call.fn, arg.describe())
            if ck in by_key:
                continue
            simple = isinstance(call.arg, A.ColumnRef)
            if simple:
                value = arg.output_name()
            else:
                value = f"__agg{computed}"
                computed += 1
            entry = {"call": call, "fn": call.fn, "arg": arg,
                     "simple": simple, "value": value, "out": None}
            by_key[ck] = entry
            calls.append(entry)

        # pre-aggregation projection only when an argument is computed —
        # simple-column aggregations keep the hand-built tree shape
        # (Aggregate directly over the join/filter), sharing cache keys.
        if computed:
            pre: list[Expr] = [col(k) for k in keys]
            seen = set(keys)
            for entry in calls:
                if entry["simple"]:
                    if entry["value"] not in seen:
                        pre.append(col(entry["value"]))
                        seen.add(entry["value"])
                else:
                    pre.append(entry["arg"].alias(entry["value"]))
                    seen.add(entry["value"])
            op = L.Project(op, tuple(pre))

        # output names: select-item aliases win; unaliased simple calls
        # follow resolve_agg_specs' `{value}_{fn}` de-collided default
        # so SQL and the hand-built group_by().agg() path name (and
        # cache) identically.
        def call_of(e: Any) -> "dict | None":
            if not isinstance(e, A.AggCall):
                return None
            arg = self.compile_scalar(e.arg, self.ns_column)
            return by_key.get((e.fn, arg.describe()))

        used_outs = set(keys)

        def default_out(value: str, fn: str) -> str:
            out = f"{value}_{fn}"
            i = 1
            while out in used_outs:
                out = f"{value}_{fn}_{i}"
                i += 1
            return out

        for idx, item in enumerate(self.q.items):
            entry = call_of(item.expr)
            if entry is None or entry["out"] is not None:
                continue
            if item.alias is not None:
                if item.alias in used_outs:
                    raise self.err(
                        f"duplicate output column {item.alias!r} "
                        f"in select list (alias or qualify it)")
                if item.alias.startswith("_"):
                    raise self.err(
                        f"output column {item.alias!r} must not "
                        f"start with '_'")
                entry["out"] = item.alias
            elif entry["simple"]:
                entry["out"] = default_out(entry["value"], entry["fn"])
            else:
                entry["out"] = f"col{idx}"
            used_outs.add(entry["out"])
        for entry in calls:          # embedded-only calls: internal name
            if entry["out"] is None:
                entry["out"] = default_out(entry["value"], entry["fn"])
                used_outs.add(entry["out"])

        specs = tuple((e["fn"], e["value"], e["out"]) for e in calls)
        op = L.Aggregate(op, keys=tuple(keys), specs=specs)

        # post-aggregation namespace: keys pass through, aggregates by
        # the backend dtype contract.
        pre_dummy = dummy_table(self.ns_info)
        post_ns: dict[str, ColInfo] = {
            k: self.ns_info[k] for k in keys}
        for entry in calls:
            arg_info = infer_expr(
                entry["arg"], pre_dummy, context=self.context,
                what=f"{entry['fn'].upper()} argument")
            post_ns[entry["out"]] = agg_result(
                entry["fn"], arg_info, context=self.context,
                display=entry["arg"].describe())

        def post_column(ref: A.ColumnRef) -> Expr:
            s, c = self.resolve(ref)
            phys = self.phys[(s, c)]
            if phys not in keys:
                raise self.err(
                    f"column {ref.display()!r} must appear in GROUP "
                    f"BY or inside an aggregate")
            return col(phys)

        def post_agg(e: A.AggCall) -> Expr:
            entry = call_of(e)
            assert entry is not None
            return col(entry["out"])

        items: list[tuple[Expr, tuple[int, str] | None]] = []
        names: list[str] = []
        for idx, item in enumerate(self.q.items):
            if isinstance(item.expr, A.Star):
                raise self.err("'*' cannot be combined with GROUP BY")
            entry = call_of(item.expr)
            if entry is not None:
                out = item.alias or entry["out"]
                items.append((col(entry["out"]).alias(out), None))
            elif isinstance(item.expr, A.ColumnRef):
                out = self._item_name(item, idx)
                e = post_column(item.expr)
                items.append((e.alias(out), key_origin[e.output_name()]))
            else:
                out = self._item_name(item, idx)
                e = self.compile_scalar(item.expr, post_column,
                                        post_agg)
                items.append((e.alias(out), None))
            names.append(items[-1][0].output_name())
        self._check_dup(names)
        return op, tuple(keys), specs, post_ns, items

    # -- ORDER BY --------------------------------------------------------
    def _order_keys(self, item_exprs) -> tuple[tuple[str, bool], ...]:
        if not self.q.order_by:
            return ()
        out_names = [e.output_name() for e, _ in item_exprs]
        origins = {origin: e.output_name()
                   for e, origin in item_exprs if origin is not None}
        keys: list[tuple[str, bool]] = []
        for oi in self.q.order_by:
            ref = oi.ref
            if ref.table is None and ref.name in out_names:
                keys.append((ref.name, oi.ascending))
                continue
            # qualified (or aliased-away) ref: accept it when a bare
            # select item passes exactly that source column through.
            target = None
            try:
                s, c = self.resolve(ref)
            except SqlCompileError:
                s = c = None  # type: ignore[assignment]
            if c is not None:
                phys = self.phys.get((s, c))
                if phys is not None and phys in self.ns:
                    target = origins.get(self.ns[phys])
            if target is None:
                raise self.err(
                    f"ORDER BY column {ref.display()!r} must appear "
                    f"in the select list")
            keys.append((target, oi.ascending))
        return tuple(keys)

    # -- output contract synthesis ---------------------------------------
    def _synthesize_schema(self, schema_name: str,
                           out_ns: Mapping[str, ColInfo],
                           item_exprs) -> type[S.Schema]:
        dummy = dummy_table(out_ns)
        cols: dict[str, Any] = {}
        for e, origin in item_exprs:
            out = e.output_name()
            dtype, nullable = infer_expr(
                e, dummy, context=self.context,
                what=f"select item {e.describe()!r}")
            lineage = None
            if origin is not None:
                s, c = origin
                lineage = f"{self.scopes[s].schema.__name__}.{c}"
            cols[out] = S.Column(out, dtype, nullable=nullable,
                                 inherited_from=lineage)
        return S.Schema.of(schema_name, **cols)


def compile_query(query: str, *, name: str,
                  schemas: Mapping[str, type[S.Schema]],
                  context: str,
                  schema_name: str | None = None) -> CompiledQuery:
    """Parse + compile ``query`` against the given table contracts.

    ``schemas`` maps every *visible* table name to its contract (the
    catalog tables at a pinned ref, or a pipeline's sources + upstream
    node outputs); ``context`` names that universe in error messages
    (e.g. ``ref 'main' (commit ab12...)``). Raises
    :class:`~repro_torch.sql.errors.SqlParseError` /
    :class:`~repro_torch.sql.errors.SqlCompileError` — both PlanErrors: an
    ill-typed query is rejected at the control plane, before any
    worker touches data.
    """
    from repro_torch.obs import get_recorder

    rec = get_recorder()
    if not rec.enabled:
        q = parse(query)
        return _Compiler(query, q, schemas, context).compile(
            name=name, schema_name=schema_name)
    with rec.span("parse"):
        q = parse(query)
    with rec.span("compile", tables=list(q.table_names())) as sp:
        compiled = _Compiler(query, q, schemas, context).compile(
            name=name, schema_name=schema_name)
        sp.set(output_schema=compiled.output_schema.__name__)
    return compiled
