"""The rewrite passes: each is ``Plan -> Plan`` with a provenance trail.

The rewrite-pass contract (DESIGN.md §11): **every pass preserves
bit-for-bit published-table semantics** — values, validity masks, row
order, NULL fills. The proof obligation is the differential suite
(``tests/test_optimizer_differential.py``: every fixture pipeline runs
optimized and unoptimized across every registered backend and the
published snapshots must fingerprint identically); the arguments for
*why* each rewrite is safe live on the passes below and in DESIGN.md.
A pass that cannot prove a rewrite applies leaves the tree alone —
opaque expressions (``Expr.references() is None``), non-inner joins
where the rewrite needs inner semantics, missing statistics: all are
"don't rewrite", never "rewrite and hope".

Shared soundness inputs:

- **left-copy-wins**: a join output takes name-shadowed columns from
  the left side (``_gather_right`` skips names already present), which
  is what makes left-pushes and keep-everywhere pruning order-safe;
- **declared schemas**: pushdown/pruning reason over contract-declared
  column sets. The documented conformance caveat: physical tables may
  carry *extra* undeclared columns, and the passes assume those extras
  never shadow a declared column of the other join side (an undeclared
  left column named like a declared right column would flip a
  right-push's copy source). Steps whose output is a projection are
  immune — extras never reach their published output;
- **contract reference sets** (:func:`repro_torch.core.contracts.referenced_columns`):
  the Appendix-A elision condition — a source column may only be
  elided when no contract verifier and no downstream reference needs
  it.

Float-SUM carve-out: the backends' one cross-backend tolerance is
float SUM/MEAN summation order. No *restructuring* pass reorders an
aggregation — pushdown/reorder/pruning/fusion touch scans, filters,
projections and joins, all of which gather rows rather than summing
(filter-below-Aggregate preserves every surviving group's row set
exactly) — so their optimized-vs-unoptimized equality is exact, not
tolerance-based. The one exception is ``partial_agg``, which is
physical routing: it changes *where* an aggregation runs (the
partitioned backend's per-partition partials, when it spans several
cards), which regroups float sums within the documented carve-out;
integer aggregates remain bit-for-bit, and the strategy renders in
``describe()`` so the cache key moves with it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from repro_torch.core import planner as P
from repro_torch.core import schema as S
from repro_torch.core.contracts import (check_node, provable_postconditions,
                                  referenced_columns)
from repro_torch.core.dag import DeclarativeNode
from repro_torch.core.logical import (Aggregate, Filter, Join, Limit,
                                LogicalOp, Project, Reorder, Scan, Sort)

__all__ = ["DEFAULT_PASSES", "PASSES", "optimize",
           "filter_pushdown", "join_reorder", "column_pruning",
           "probe_fusion", "partial_agg"]

# Selectivity assumed for a filtered side when ordering joins — a
# cost-model constant, not semantics (a bad estimate costs time, never
# correctness: the reorder is bit-for-bit by construction).
DEFAULT_FILTER_SELECTIVITY = 0.33


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------
# NOTE: never compare ops or exprs with `==` — Expr overloads equality
# to BUILD expressions. Identity of a subtree is its describe() string
# (total and structural, the same property cache keys rely on).

def _walk(op: LogicalOp):
    yield op
    for c in op.children():
        yield from _walk(c)


def _map_children(op: LogicalOp,
                  fn: Callable[[LogicalOp], LogicalOp]) -> LogicalOp:
    if isinstance(op, (Filter, Project, Aggregate, Sort, Limit)):
        return dataclasses.replace(op, child=fn(op.child))
    if isinstance(op, Join):
        return dataclasses.replace(op, left=fn(op.left),
                                   right=fn(op.right))
    if isinstance(op, Reorder):
        return dataclasses.replace(
            op, base=fn(op.base),
            sides=tuple((fn(s), on) for s, on in op.sides))
    return op


def _schemas(plan: P.Plan) -> dict[str, type[S.Schema]]:
    out: dict[str, type[S.Schema]] = dict(plan.source_schemas)
    for s in plan.steps:
        out[s.node.name] = s.node.output_schema
    return out


def _op_cols(op: LogicalOp, schemas: Mapping[str, type[S.Schema]]
             ) -> set[str] | None:
    """Declared output-column set of a subtree; None = unknown."""
    if isinstance(op, Scan):
        if op.table not in schemas:
            return None
        cols = set(schemas[op.table].names())
        if op.columns is not None:
            cols &= set(op.columns)
        return cols
    if isinstance(op, (Filter, Sort, Limit)):
        return _op_cols(op.child, schemas)
    if isinstance(op, Project):
        return {e.output_name() for e in op.exprs}
    if isinstance(op, Aggregate):
        return set(op.keys) | {out for _fn, _value, out in op.specs}
    if isinstance(op, (Join, Reorder)):
        acc: set[str] = set()
        for c in op.children():
            sub = _op_cols(c, schemas)
            if sub is None:
                return None
            acc |= sub
        return acc
    return None


def _tree_refs(op: LogicalOp) -> set[str] | None:
    """Every input-column name any expression or join key in the tree
    reads; None if any expression is opaque (unknown reads)."""
    refs: set[str] = set()
    for node in _walk(op):
        if isinstance(node, Join):
            refs |= set(node.on)
        if isinstance(node, Reorder):
            for _, on in node.sides:
                refs |= set(on)
        if isinstance(node, Aggregate):
            refs |= set(node.keys)
            refs |= {value for _fn, value, _out in node.specs}
        if isinstance(node, Sort):
            # sort keys name OUTPUT columns of the op below (usually a
            # Project); folding them into the reference set is
            # conservative — it can only keep more source columns alive.
            refs |= {name for name, _asc in node.keys}
        for e in node._own_exprs():
            r = e.references()
            if r is None:
                return None
            refs |= r
        if isinstance(node, Project):
            for e in node.exprs:
                r = e.references()
                if r is None:
                    return None
                refs |= r
    return refs


# ---------------------------------------------------------------------------
# pass: filter pushdown (+ shared-filter materialization)
# ---------------------------------------------------------------------------

def filter_pushdown(plan: P.Plan) -> P.Plan:
    """Push ``Filter`` below ``Join`` where the predicate provably
    reads one side, then hoist filters that now appear identically in
    several steps into one shared auxiliary (unpublished) step.

    Left-push (``refs ⊆ left cols``; inner or left join): the joined
    value of every referenced name is the LEFT copy (left-copy-wins),
    so the predicate sees identical values above and below; filtering
    left rows before the join drops exactly the rows whose every
    emitted copy the post-join filter would drop, in the same order.
    Valid for left joins too — an unmatched left row's referenced
    values are its own.

    Right-push (``refs ⊆ right cols`` and ``refs ∩ left cols ⊆ on``;
    inner only): any referenced name also present on the left must be
    a join key, where matched rows guarantee left copy == right copy;
    purely-right names reach the output from the right side. Dropping
    right rows pre-join removes exactly the match pairs the post-join
    filter would drop. Not valid for left joins (a dropped right row
    must yield an unmatched NULL-filled emission, not a dropped one).

    Aggregate-push (``refs ⊆ group keys``, non-float key dtypes): an
    output row's key columns hold its group's key values, and every
    row of a group carries an equal key value, so a key-only predicate
    decides identically for a group above the ``Aggregate`` and for
    each of the group's rows below it — surviving groups keep exactly
    their original row sets (aggregates and summation order unchanged)
    in first-appearance order, and the NULL-keyed group behaves the
    same way because a NULL predicate input drops the row on both
    sides. The dtype guard is load-bearing: *float* keys group
    value-equal but bit-distinct representatives (``-0.0 == 0.0``),
    which an arithmetic predicate (``1/k > 0``) can tell apart — a
    per-row push could then keep a different representative (or a
    group the post-aggregation filter dropped), so float-keyed
    predicates stay above.
    """
    schemas = _schemas(plan)
    pushed: set[str] = set()

    def push(op: LogicalOp) -> LogicalOp:
        if isinstance(op, Filter):
            child = push(op.child)
            return sink(op.pred, child)
        return _map_children(op, push)

    def sink(pred, op: LogicalOp) -> LogicalOp:
        refs = pred.references()
        if (refs is not None and isinstance(op, Join)
                and op.left_pred is None and op.right_pred is None):
            lcols = _op_cols(op.left, schemas)
            rcols = _op_cols(op.right, schemas)
            if lcols is not None and rcols is not None:
                if refs <= lcols and op.how in ("inner", "left"):
                    pushed.add("join")
                    return dataclasses.replace(
                        op, left=sink(pred, op.left))
                if (op.how == "inner" and refs <= rcols
                        and refs & lcols <= set(op.on)):
                    pushed.add("join")
                    return dataclasses.replace(
                        op, right=sink(pred, op.right))
        if (refs is not None and isinstance(op, Aggregate)
                and refs <= set(op.keys)
                and _agg_keys_pushable(refs, op.child, schemas)):
            pushed.add("aggregate")
            return dataclasses.replace(op, child=sink(pred, op.child))
        return Filter(op, pred)

    new_steps: list[P.PlanStep] = []
    for step in plan.steps:
        if step.logical is None:
            new_steps.append(step)
            continue
        pushed.clear()
        tree = push(step.logical)
        if tree.describe() != step.logical.describe():
            what = " and ".join(sorted(pushed)) or "join"
            step = dataclasses.replace(
                step, logical=tree,
                provenance=step.provenance
                + (f"filter_pushdown: pushed filter below {what}",))
        new_steps.append(step)

    return _materialize_shared_filters(plan, new_steps, schemas)


def _agg_keys_pushable(refs: set[str], child: LogicalOp,
                       schemas) -> bool:
    """True iff every referenced group key resolves to a declared
    non-float column below the Aggregate (the value-determined-
    representative condition of the aggregate push: int/bool/str/
    datetime equality implies bit-identical payloads, float does not)."""
    for name in refs:
        families = {
            schemas[node.table].columns()[name].dtype.family
            for node in _walk(child)
            if isinstance(node, Scan) and node.table in schemas
            and name in schemas[node.table].columns()
            and (node.columns is None or name in node.columns)}
        if not families or "float" in families:
            return False
    return True


def _materialize_shared_filters(plan: P.Plan,
                                steps: list[P.PlanStep],
                                schemas) -> P.Plan:
    """Hoist a ``Filter(Scan(t), pred)`` subtree appearing (by
    structural description) in two or more places into ONE unpublished
    auxiliary step, so the filter runs once instead of per consumer.
    Sound trivially — consumers read a materialization of the exact
    subtree they contained — but it *moves waves*: consumers gain a
    dependency level, which is why :func:`repro_torch.core.planner.rebuild`
    recomputes wave numbering after every pass."""
    counts: dict[str, tuple] = {}
    for step in steps:
        if step.logical is None:
            continue
        for node in _walk(step.logical):
            if (isinstance(node, Filter)
                    and isinstance(node.child, Scan)
                    and node.child.columns is None
                    and node.child.table in schemas
                    and getattr(node.pred, "_structural", False)
                    and node.pred.references() is not None):
                d = node.describe()
                n, _ = counts.get(d, (0, None))
                counts[d] = (n + 1, node)
    shared = {d: node for d, (n, node) in counts.items() if n >= 2}
    if not shared:
        return P.rebuild(plan, steps)

    used = {s.node.name for s in steps} | set(plan.source_schemas)
    out: list[P.PlanStep] = list(steps)
    aux_i = 0
    for desc, subtree in sorted(shared.items()):
        table = subtree.child.table
        schema = schemas[table]
        while f"__opt_shared_{aux_i}" in used:
            aux_i += 1
        aux_name = f"__opt_shared_{aux_i}"
        used.add(aux_name)

        def replace(op: LogicalOp) -> LogicalOp:
            if op.describe() == desc:
                return Scan(aux_name)
            return _map_children(op, replace)

        first_consumer = None
        stats = None
        for i, step in enumerate(out):
            if step.logical is None:
                continue
            tree = replace(step.logical)
            if tree.describe() == step.logical.describe():
                continue
            if first_consumer is None:
                first_consumer = i
                if step.input_stats and table in step.input_stats:
                    stats = {table: step.input_stats[table]}
            tabs = sorted(tree.scan_tables())
            node = dataclasses.replace(
                step.node,
                inputs={t: t for t in tabs},
                input_schemas={t: (schema if t == aux_name
                                   else schemas[t]) for t in tabs})
            out[i] = dataclasses.replace(
                step, node=node, logical=tree,
                provenance=step.provenance
                + (f"filter_pushdown: shared filter on {table!r} "
                   f"materialized as {aux_name!r}",))
        if first_consumer is None:     # pragma: no cover - defensive
            continue
        aux_node = DeclarativeNode(
            name=aux_name, inputs={table: table},
            input_schemas={table: schema}, output_schema=schema,
            filter_expr=subtree.pred)
        aux_step = P.PlanStep(
            node=aux_node,
            report=check_node({table: schema}, schema),
            elided_null_checks=provable_postconditions(
                {table: schema}, schema, inspectable=True,
                null_preserving=True),
            input_stats=stats,
            logical=Filter(Scan(table), subtree.pred),
            published=False,
            provenance=(f"filter_pushdown: materialized shared "
                        f"filter {desc}",))
        out.insert(first_consumer, aux_step)
        schemas[aux_name] = schema
    return P.rebuild(plan, out)


# ---------------------------------------------------------------------------
# pass: join reordering (cardinality-driven)
# ---------------------------------------------------------------------------

def join_reorder(plan: P.Plan) -> P.Plan:
    """Reorder an all-inner left-deep join chain to probe estimated-
    small sides first, wrapped in :class:`Reorder` so the original
    row/column order is restored — the rewrite is bit-for-bit by
    construction, the estimates only pick which order to *execute*.

    Requirements (else leave alone): >= 2 sides; every base/side is a
    ``Scan`` or ``Filter(Scan)``; planner ``TableStats`` present for
    every side's table; pairwise-disjoint declared side column sets
    (base overlap is fine — base stays leftmost, so its copies win in
    every order). Greedy order: repeatedly take the smallest-estimate
    side whose join keys are all available; the smallest-index
    unordered side is always eligible, so the greedy never deadlocks.
    """
    schemas = _schemas(plan)
    new_steps: list[P.PlanStep] = []
    for step in plan.steps:
        rewritten = (_reorder_tree(step, schemas)
                     if step.logical is not None else None)
        if rewritten is None:
            new_steps.append(step)
        else:
            tree, msg = rewritten
            new_steps.append(dataclasses.replace(
                step, logical=tree,
                provenance=step.provenance + (msg,)))
    return P.rebuild(plan, new_steps)


def _reorder_tree(step: P.PlanStep, schemas):
    # peel Project/Filter/Aggregate/Sort/Limit wrappers down to the
    # join chain root (Reorder restores exact row order, so any
    # row-order-sensitive op above it — an Aggregate's groups,
    # representatives and summation order, a Sort's tiebreaks, a
    # Limit's prefix — sees identical input)
    wrappers: list[LogicalOp] = []
    op = step.logical
    while isinstance(op, (Project, Filter, Aggregate, Sort, Limit)):
        wrappers.append(op)
        op = op.child
    if not isinstance(op, Join):
        return None
    sides: list[tuple[LogicalOp, tuple[str, ...]]] = []
    cur: LogicalOp = op
    while (isinstance(cur, Join) and cur.how == "inner"
           and cur.left_pred is None and cur.right_pred is None):
        sides.append((cur.right, cur.on))
        cur = cur.left
    base = cur
    sides.reverse()
    if len(sides) < 2 or isinstance(base, Join):
        return None

    def scan_of(side: LogicalOp):
        if isinstance(side, Scan):
            return side, 1.0
        if isinstance(side, Filter) and isinstance(side.child, Scan):
            return side.child, DEFAULT_FILTER_SELECTIVITY
        return None, 0.0

    base_scan, _ = scan_of(base)
    if base_scan is None:
        return None
    stats = step.input_stats or {}
    ests: list[float] = []
    side_cols: list[set[str]] = []
    for side, _on in sides:
        scan, sel = scan_of(side)
        if scan is None or scan.table not in stats:
            return None
        st = stats[scan.table]
        n = getattr(st, "n_rows", None)
        if n is None:
            return None
        ests.append(n * sel)
        cols = _op_cols(side, schemas)
        if cols is None:
            return None
        side_cols.append(cols)
    for i in range(len(sides)):
        for j in range(i + 1, len(sides)):
            if side_cols[i] & side_cols[j]:
                return None              # shadowing would depend on order
    base_cols = _op_cols(base, schemas)
    if base_cols is None:
        return None

    available = set(base_cols)
    remaining = list(range(len(sides)))
    order: list[int] = []
    while remaining:
        ready = [k for k in remaining if set(sides[k][1]) <= available]
        k = min(ready, key=lambda k: (ests[k], k))
        order.append(k)
        remaining.remove(k)
        available |= side_cols[k]
    if order == sorted(order):
        return None                      # already cheapest-first

    tree: LogicalOp = Reorder(base=base, sides=tuple(sides),
                              order=tuple(order))
    for w in reversed(wrappers):
        tree = dataclasses.replace(w, child=tree)
    est_txt = ", ".join(f"{i}:{e:.0f}" for i, e in enumerate(ests))
    return tree, (f"join_reorder: order={order} by estimated rows "
                  f"[{est_txt}]")


# ---------------------------------------------------------------------------
# pass: dead-column elision (projection pushdown)
# ---------------------------------------------------------------------------

def column_pruning(plan: P.Plan) -> P.Plan:
    """Elide source columns no expression, join key, contract verifier
    or downstream consumer references (Appendix-A elision soundness).

    Applies only to steps whose tree root is a ``Project`` or an
    ``Aggregate`` — their published output is exactly the projected
    (resp. keys + aggregate) columns, so mid-tree column sets are
    unobservable and pruning cannot change the output
    ... with one structural caveat handled by *keep-everywhere*: a
    needed name present in several scans must stay in ALL of them, or
    left-copy-wins would resolve it to a different copy. The keep set
    is therefore global per step: every tree reference + every column
    the output contract resolves to an input (the verifier's reach);
    every scan keeps exactly its intersection with that set.

    Second phase: an *auxiliary* (unpublished) step's output schema may
    itself shrink when every downstream scan of it is pruned — the "no
    downstream step references it" half of the elision condition;
    verifiers only ever attach to published tables, so the contract
    half is vacuous for aux steps.
    """
    schemas = _schemas(plan)
    new_steps: list[P.PlanStep] = []
    for step in plan.steps:
        pruned = (_prune_step(step, schemas)
                  if step.logical is not None else None)
        if pruned is None:
            new_steps.append(step)
        else:
            tree, msg = pruned
            new_steps.append(dataclasses.replace(
                step, logical=tree,
                provenance=step.provenance + (msg,)))
    new_steps = _prune_aux_outputs(new_steps, schemas)
    return P.rebuild(plan, new_steps)


def _prune_step(step: P.PlanStep, schemas):
    tree = step.logical
    # an Aggregate root is as prunable as a Project root: its output
    # is exactly keys + spec outputs, so mid-tree column sets are just
    # as unobservable. Sort/Limit wrappers above such a root are
    # column-transparent (pure row selection/permutation), so peel them
    # when testing the shape — the prune itself rewrites scans only.
    root = tree
    while isinstance(root, (Sort, Limit)):
        root = root.child
    if not isinstance(root, (Project, Aggregate)):
        return None
    needed = _tree_refs(tree)
    if needed is None:
        return None                      # opaque expression somewhere
    inputs = {t: schemas[t] for t in set(step.node.inputs.values())
              if t in schemas}
    computed: set[str] = set()
    if isinstance(step.node, DeclarativeNode) and step.node.agg_specs:
        computed = {out for _fn, _value, out in step.node.agg_specs}
    contract = referenced_columns(inputs, step.node.output_schema,
                                  computed=computed)
    keep = set(needed)
    for cols in contract.values():
        keep |= cols
    # names in the keep set that no input DECLARES may still exist
    # physically (the conformance caveat allows extras) — every scan
    # must keep them; declared names keep per-scan intersection.
    all_declared: set[str] = set()
    for node in _walk(tree):
        if isinstance(node, Scan) and node.table in schemas:
            all_declared |= set(schemas[node.table].names())
    extras = keep - all_declared
    elided: dict[str, list[str]] = {}

    def prune(op: LogicalOp) -> LogicalOp:
        if isinstance(op, Scan) and op.columns is None \
                and op.table in schemas:
            declared = set(schemas[op.table].names())
            drop = sorted(declared - keep)
            if drop:
                elided[op.table] = drop
                return Scan(op.table,
                            columns=tuple(sorted((keep & declared)
                                                 | extras)))
            return op
        return _map_children(op, prune)

    new_tree = prune(tree)
    if not elided:
        return None
    msg = "; ".join(f"{t}: -{cols}" for t, cols in sorted(elided.items()))
    return new_tree, (f"column_pruning: elided unreferenced source "
                      f"columns ({msg})")


def _prune_aux_outputs(steps: list[P.PlanStep], schemas):
    out = list(steps)
    for i, step in enumerate(out):
        if step.published or not isinstance(step.node, DeclarativeNode):
            continue
        name = step.node.name
        consumed: set[str] = set()
        consumers = []
        prunable = True
        for j, other in enumerate(out):
            if j == i or name not in set(other.node.inputs.values()):
                continue
            consumers.append(j)
            if other.logical is None:
                prunable = False
                break
            for node in _walk(other.logical):
                if isinstance(node, Scan) and node.table == name:
                    if node.columns is None:
                        prunable = False
                        break
                    consumed |= set(node.columns)
            if not prunable:
                break
        if not prunable or not consumers:
            continue
        own = _tree_refs(step.logical) if step.logical is not None \
            else None
        if own is None:
            continue
        keep = consumed | own
        declared = step.node.output_schema.columns()
        drop = sorted(set(declared) - keep)
        if not drop:
            continue
        kept_cols = {n: c for n, c in declared.items() if n in keep}
        pruned_schema = S.Schema.of(
            f"{step.node.output_schema.__name__}Pruned", **kept_cols)
        # shrink the aux's own scan too: the dropped columns are never
        # read by anyone, so they need not even be materialized.
        def shrink(op: LogicalOp) -> LogicalOp:
            if isinstance(op, Scan) and op.columns is None:
                return Scan(op.table, columns=tuple(sorted(keep)))
            return _map_children(op, shrink)

        in_schemas = {t: schemas[t]
                      for t in set(step.node.inputs.values())
                      if t in schemas}
        node = dataclasses.replace(step.node,
                                   output_schema=pruned_schema)
        out[i] = dataclasses.replace(
            step, node=node,
            logical=shrink(step.logical),
            report=check_node(in_schemas, pruned_schema,
                              casts=step.node.casts),
            elided_null_checks=provable_postconditions(
                in_schemas, pruned_schema, inspectable=True,
                null_preserving=step.node.null_preserving),
            provenance=step.provenance
            + (f"column_pruning: aux output pruned to {sorted(keep)} "
               f"— no downstream step or contract verifier references "
               f"{drop}",))
        schemas[name] = pruned_schema
        for j in consumers:
            other = out[j]
            out[j] = dataclasses.replace(
                other, node=dataclasses.replace(
                    other.node,
                    input_schemas={
                        t: (pruned_schema if t == name else sch)
                        for t, sch in other.node.input_schemas.items()
                    }))
    return out


# ---------------------------------------------------------------------------
# pass: probe fusion (filter_select fused into the join probe)
# ---------------------------------------------------------------------------

def probe_fusion(plan: P.Plan) -> P.Plan:
    """Fuse a ``Filter`` feeding a ``Join`` into the join's masked
    probe (``Backend.masked_hash_join``): the predicate mask travels
    into the probe, so the filtered intermediate is never
    materialized — on the card the mask is applied inside the
    ``masked_hash_probe`` kernel. Semantically the identity rewrite:
    ``masked_hash_join`` is *defined* as filter-then-join (base.py),
    which is exactly the tree being replaced. Left-side fusion only under inner joins (backends
    would prefilter for left joins anyway — no fusion win); right-side
    fusion under inner and left joins. Chained filters compose with
    ``&`` (same mask: SQL NULL-drop distributes over conjunction).
    """
    fused = [0]

    def fuse(op: LogicalOp) -> LogicalOp:
        op = _map_children(op, fuse)
        if not isinstance(op, Join):
            return op
        left, right = op.left, op.right
        lp, rp = op.left_pred, op.right_pred
        if op.how == "inner":
            while isinstance(left, Filter):
                lp = left.pred if lp is None else (left.pred & lp)
                left = left.child
        while isinstance(right, Filter):
            rp = right.pred if rp is None else (right.pred & rp)
            right = right.child
        if lp is op.left_pred and rp is op.right_pred:
            return op
        fused[0] += 1
        return dataclasses.replace(op, left=left, right=right,
                                   left_pred=lp, right_pred=rp)

    new_steps: list[P.PlanStep] = []
    for step in plan.steps:
        if step.logical is None:
            new_steps.append(step)
            continue
        fused[0] = 0
        tree = fuse(step.logical)
        if fused[0]:
            step = dataclasses.replace(
                step, logical=tree,
                provenance=step.provenance
                + (f"probe_fusion: fused {fused[0]} filter(s) into "
                   f"join probe masks",))
        new_steps.append(step)
    return P.rebuild(plan, new_steps)


# ---------------------------------------------------------------------------
# pass: partitioned partial aggregation
# ---------------------------------------------------------------------------

def partial_agg(plan: P.Plan) -> P.Plan:
    """Route large single-int-key ``Aggregate`` ops through the
    partitioned backend's pre-exchange partial aggregation
    (``Aggregate.strategy="partial"``).

    A physical-routing rewrite, not a tree restructuring: every
    strategy computes the same table, and the partitioned backend
    re-validates its own preconditions at dispatch (degrading to the
    inherited path when the data disagrees with the plan-time stats),
    so a stale estimate costs time, never correctness. The one
    observable difference is the documented float-SUM/MEAN
    summation-order carve-out — which is exactly why a non-default
    strategy renders in ``describe()`` and therefore moves the step's
    cache key; integer aggregates stay bit-for-bit and the
    differential suite pins them exactly.

    Gate (all must hold, read at optimize time): plan-time stats show
    ``n_rows >= repro_torch.exec.torch_auto.SHARD_ROWS`` for the
    aggregate's one source table; the registered ``partitioned``
    backend constructs and spans more than one card (the instance
    ``Aggregate._exec`` will run, so the plan-time gate and the run-time
    backend agree; on one card the pass is a no-op, as ``repro``'s is on
    one device); the single group key is declared with an integer dtype
    by that source (the dense-rebase partial path only handles int keys
    — anything else would just flip the strategy and fall straight back
    at dispatch).
    """
    from repro_torch.exec import torch_auto as auto_mod
    devices = _mesh_devices()
    if devices <= 1:
        return P.rebuild(plan, list(plan.steps))
    shard_rows = auto_mod.SHARD_ROWS

    schemas = _schemas(plan)
    new_steps: list[P.PlanStep] = []
    for step in plan.steps:
        if step.logical is None:
            new_steps.append(step)
            continue
        notes: list[str] = []

        def route(op: LogicalOp) -> LogicalOp:
            op = _map_children(op, route)
            if not (isinstance(op, Aggregate)
                    and op.strategy == "auto" and len(op.keys) == 1):
                return op
            tables = sorted(op.child.scan_tables())
            if len(tables) != 1:
                return op
            table = tables[0]
            st = (step.input_stats or {}).get(table)
            n = getattr(st, "n_rows", None)
            if n is None or n < shard_rows:
                return op
            key = op.keys[0]
            sch = schemas.get(table)
            if (sch is None or key not in sch.columns()
                    or sch.columns()[key].dtype.family != "int"):
                return op
            notes.append(
                f"partial_agg: aggregate on {table!r} routed to "
                f"partitioned partial aggregation (rows={n} >= "
                f"{shard_rows}, devices={devices})")
            return dataclasses.replace(op, strategy="partial")

        tree = route(step.logical)
        if notes:
            step = dataclasses.replace(
                step, logical=tree,
                provenance=step.provenance + tuple(notes))
        new_steps.append(step)
    return P.rebuild(plan, new_steps)


def _mesh_devices() -> int:
    """The cards the registered ``partitioned`` backend spans (one when
    it does not construct here)."""
    from repro_torch import exec as exec_backends
    try:
        return exec_backends.get_backend("partitioned").cards
    except (KeyError, exec_backends.BackendUnavailable):
        return 1


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

PASSES: dict[str, Callable[[P.Plan], P.Plan]] = {
    "filter_pushdown": filter_pushdown,
    "join_reorder": join_reorder,
    "column_pruning": column_pruning,
    "probe_fusion": probe_fusion,
    "partial_agg": partial_agg,
}

# Order matters: pushdown first (creates the Filter(Scan) shapes the
# later passes feed on), reorder over the cleaned chain, pruning once
# the tree's reads are final, fusion next (it consumes the remaining
# Filter-before-Join shapes), and partial_agg last — pure physical
# routing over the finished tree.
DEFAULT_PASSES = ("filter_pushdown", "join_reorder", "column_pruning",
                  "probe_fusion", "partial_agg")


def optimize(plan: P.Plan,
             passes: "Sequence[str] | None" = None) -> P.Plan:
    """Run the rewrite pipeline; returns a new Plan with waves
    recomputed, provenance recorded, and the active pass list stamped
    on every step (engine cache keys fold it — flipping a pass can
    never serve a stale cross-plan cache hit)."""
    from repro_torch.obs import get_recorder

    active = tuple(passes) if passes is not None else DEFAULT_PASSES
    rec = get_recorder()
    out = plan
    for name in active:
        try:
            fn = PASSES[name]
        except KeyError:
            raise ValueError(
                f"unknown optimizer pass {name!r} "
                f"(registered: {sorted(PASSES)})") from None
        if rec.enabled:
            # provenance entries are appended per step — the per-pass
            # delta is exactly the rewrites THIS pass performed (steps
            # the pass materialized count whole).
            prev = {s.node.name: len(s.provenance) for s in out.steps}
            with rec.span("optimizer_pass", name=name) as sp:
                out = fn(out)
                new = [p for s in out.steps
                       for p in s.provenance[prev.get(s.node.name, 0):]]
                sp.set(rewrites=len(new), provenance=new)
        else:
            out = fn(out)
    stamped = tuple(dataclasses.replace(s, opt_passes=active)
                    for s in out.steps)
    return P.rebuild(out, stamped, optimizer_passes=active)
