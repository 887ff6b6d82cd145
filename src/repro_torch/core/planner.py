"""The control plane: validate a DAG *before* any distributed execution.

Paper §3/Figure 1, moment (2): "before scheduling any distributed
execution, the control plane can parse the DAG metadata and validate that
adjacent nodes compose (every referenced column exists with a compatible
type, and — if the transformation language allows inspection — casts are
present when necessary)".

:func:`plan` performs, in order:
  1. structural validation (acyclicity, resolvable inputs, unique outputs);
  2. per-node contract composition (:func:`repro_torch.core.contracts.check_node`)
     including cast/narrowing legality;
  3. Appendix-A static discharge: computes, per node, the set of NOT-NULL
     checks that are provable and can be elided at the worker;
  4. logical lowering: inspectable declarative nodes carry their
     :mod:`repro_torch.core.logical` tree on the step, which is what the
     optimizer (:mod:`repro_torch.optimizer`) rewrites and the engine
     executes.

The result is an immutable :class:`Plan`; :mod:`repro_torch.core.runner`
executes plans, never raw pipelines — so an invalid DAG can never reach
a worker ("ill-typed pipelines should not be planned"). Optimizer
passes produce *new* Plans through :func:`rebuild` (waves are
recomputed — a pushdown can change the critical path) and stamp their
provenance onto the steps they touched; ``Plan.describe()`` renders
that trail as the EXPLAIN section.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core import schema as S
from repro_torch.core.contracts import (EdgeReport, check_node,
                                  provable_postconditions)
from repro_torch.core.dag import Node, Pipeline
from repro_torch.core.errors import PlanError

__all__ = ["PlanStep", "Plan", "plan", "rebuild"]

# stat entries rendered per step in describe() before truncation —
# agents parse this output, and one unbounded sorted line per step made
# wide pipelines unreadable (and unparseable past terminal limits).
_DESCRIBE_STATS_MAX = 3


@dataclasses.dataclass(frozen=True)
class PlanStep:
    node: Node
    report: EdgeReport
    elided_null_checks: frozenset[str]  # statically discharged (App. A)
    wave: int = 0                       # dependency level (DESIGN.md §8)
    # per-input table statistics (repro_torch.exec.stats.TableStats), keyed
    # by table name — recorded when the caller supplies stats for the
    # tables it can see (sources; intermediate outputs are unknown at
    # the control-plane moment). Feeds observability and the ``auto``
    # execution backend's decision table (DESIGN.md §10); absence means
    # "unknown", never "empty".
    input_stats: "Mapping[str, object] | None" = None
    # logical IR (repro_torch.core.logical.LogicalOp) for inspectable
    # declarative nodes — what the optimizer rewrites and the engine
    # executes; None = opaque node, run through node.run().
    logical: "object | None" = None
    # False for optimizer-materialized auxiliary steps (e.g. a shared
    # filter hoisted out of two consumers): they execute and cache like
    # any step but are not published pipeline outputs — the runner must
    # not commit them to the catalog.
    published: bool = True
    # human-readable rewrite trail ("why this tree looks like this"),
    # appended by each optimizer pass that touched this step. Folded
    # into the engine cache key: a step whose tree was rewritten
    # differently must never share a cache entry.
    provenance: tuple[str, ...] = ()
    # the active optimizer pass list (stamped on every step of an
    # optimized plan, touched or not) — cache-key material so flipping
    # a pass on/off can never serve a stale cross-plan hit.
    opt_passes: tuple[str, ...] = ()

    def execute(self, tables) -> "object":
        """Run this step's transformation: the (possibly rewritten)
        logical tree when present, the node body otherwise."""
        if self.logical is not None:
            return self.logical.execute(tables,
                                        stats=self.input_stats)
        return self.node.run(tables)

    def cache_material(self) -> str | None:
        """Static cache-key half for this step (see
        ``Node.cache_material``). A rewritten logical tree replaces the
        node's source in the material — two steps executing different
        trees must key differently — but only when the tree is fully
        structural; otherwise the step is uncacheable, same rule as
        ``DeclarativeNode.cache_material``."""
        if self.logical is None:
            return self.node.cache_material()
        if not self.logical.is_structural():
            return None
        casts = ";".join(f"{c.column}->{c.to.name}"
                         for c in self.node.casts)
        return (f"<logical: {self.logical.describe()}>|"
                f"{self.node.output_schema.fingerprint()}|{casts}")


@dataclasses.dataclass(frozen=True)
class Plan:
    pipeline_name: str
    code_hash: str
    steps: tuple[PlanStep, ...]
    source_schemas: Mapping[str, type[S.Schema]]
    # the optimizer pass list this plan was produced by (empty =
    # unoptimized); mirrors PlanStep.opt_passes for plan-level display.
    optimizer_passes: tuple[str, ...] = ()

    @property
    def output_tables(self) -> tuple[str, ...]:
        """Published output tables — what the runner commits. Excludes
        optimizer-materialized auxiliary steps."""
        return tuple(s.node.name for s in self.steps if s.published)

    @property
    def waves(self) -> tuple[tuple[PlanStep, ...], ...]:
        """Steps grouped by dependency level (level scheduling): wave
        ``w`` holds every node whose longest path from a source is ``w``.
        All nodes of a wave depend only on sources and earlier waves, so
        a wave's nodes may execute concurrently; steps within a wave keep
        plan order, making wave execution deterministic."""
        grouped: dict[int, list[PlanStep]] = {}
        for s in self.steps:
            grouped.setdefault(s.wave, []).append(s)
        return tuple(tuple(grouped[w]) for w in sorted(grouped))

    def source_tables(self) -> tuple[str, ...]:
        """Source tables the plan's nodes actually read (auxiliary step
        outputs are plan-internal, not sources)."""
        outputs = {s.node.name for s in self.steps}
        seen: list[str] = []
        for s in self.steps:
            for t in s.node.inputs.values():
                if t not in outputs and t not in seen:
                    seen.append(t)
        return tuple(seen)

    def describe(self, *, analyze: bool = False) -> str:
        """EXPLAIN (and, with ``analyze=True``, EXPLAIN ANALYZE).

        ``analyze`` renders the actual per-step runtime the engine
        recorded on the last execution of THIS plan object — cache
        verdict, actual output rows (next to the TableStats
        *estimates*), and wall time — as a format-pinned ``[actual:
        cache=<verdict> rows=<n> time=<t>ms]`` suffix per step.
        Raises :class:`PlanError` if the plan has not been executed.
        """
        runtime: "Mapping[str, dict] | None" = None
        if analyze:
            runtime = getattr(self, "_runtime", None)
            if runtime is None:
                raise PlanError(
                    "describe(analyze=True) requires the plan to have "
                    "been executed (run it through PlanExecutor or "
                    "Client.run first)")
        lines = [f"plan {self.pipeline_name} (code={self.code_hash})"]
        # EXPLAIN header: nodes compiled from SQL carry their original
        # query text (display metadata only — never cache material).
        for s in self.steps:
            qtext = getattr(s.node, "query", "")
            if qtext:
                lines.append(
                    f"  query[{s.node.name}]: {' '.join(qtext.split())}")
        for s in self.steps:
            el = (f" [elided null-checks: {sorted(s.elided_null_checks)}]"
                  if s.elided_null_checks else "")
            st = ""
            if s.input_stats:
                entries = sorted(s.input_stats.items())
                shown = [
                    f"{t} {v.describe() if hasattr(v, 'describe') else v}"
                    for t, v in entries[:_DESCRIBE_STATS_MAX]]
                if len(entries) > _DESCRIBE_STATS_MAX:
                    shown.append(
                        f"+{len(entries) - _DESCRIBE_STATS_MAX} more "
                        f"(of {len(entries)})")
                st = " [stats: " + "; ".join(shown) + "]"
            an = ""
            if runtime is not None:
                rt = runtime.get(s.node.name)
                if rt is None:
                    an = " [actual: not executed]"
                else:
                    rows = rt["rows_out"]
                    an = (f" [actual: cache={rt['cache']} "
                          f"rows={'?' if rows is None else rows} "
                          f"time={rt['wall_s'] * 1000:.2f}ms]")
            aux = "" if s.published else "(aux) "
            lines.append(
                f"  [wave {s.wave}] {aux}{s.report.describe()}{el}{st}{an}")
        if self.optimizer_passes:
            rewrites = [(s.node.name, p) for s in self.steps
                        for p in s.provenance]
            lines.append(
                f"  optimizer: passes="
                f"[{', '.join(self.optimizer_passes)}]; "
                f"rewrites={len(rewrites)}")
            for name, msg in rewrites:
                lines.append(f"    - {name}: {msg}")
        return "\n".join(lines)


def rebuild(base: Plan, steps: Sequence[PlanStep], *,
            optimizer_passes: "tuple[str, ...] | None" = None) -> Plan:
    """A new Plan over rewritten ``steps`` with waves recomputed.

    Rewrites move work across the DAG (a pushdown can shorten a
    critical path; a materialized shared filter adds a level), so the
    dependency levels recorded at plan() time are stale the moment a
    pass touches an edge — recompute them from the rewritten inputs.
    ``steps`` must be topologically ordered (passes preserve plan
    order and insert auxiliary steps before their first consumer).
    """
    node_wave: dict[str, int] = {}
    rewaved: list[PlanStep] = []
    for s in steps:
        wave = max((node_wave[t] + 1 for t in s.node.inputs.values()
                    if t in node_wave), default=0)
        node_wave[s.node.name] = wave
        rewaved.append(dataclasses.replace(s, wave=wave))
    return dataclasses.replace(
        base, steps=tuple(rewaved),
        optimizer_passes=(optimizer_passes
                          if optimizer_passes is not None
                          else base.optimizer_passes))


def plan(pipeline: Pipeline,
         table_stats: "Mapping[str, object] | None" = None) -> Plan:
    """Validate and compile a pipeline into an executable Plan.

    Raises errors at Moment.CONTROL_PLANE; nothing here touches data.
    ``table_stats`` optionally maps table names to
    :class:`repro_torch.exec.stats.TableStats` (e.g. collected from catalog
    snapshots): each step records the stats of the inputs it reads in
    ``PlanStep.input_stats`` — control-plane metadata for the scheduler
    and the ``auto`` execution backend, never a correctness input.
    """
    # 1. structure: topo sort raises on cycles / missing inputs.
    order = pipeline.topo_order()

    # map table name -> schema as published by sources and earlier nodes
    published: dict[str, type[S.Schema]] = dict(pipeline.source_schemas)

    steps: list[PlanStep] = []
    node_wave: dict[str, int] = {}
    for node in order:
        # 2. contract composition: inputs must exist with known schemas.
        input_schemas: dict[str, type[S.Schema]] = {}
        for param, table in node.inputs.items():
            if table not in published:
                raise PlanError(
                    f"node {node.name!r}: input table {table!r} has no "
                    f"published schema")
            declared = node.input_schemas[param]
            actual = published[table]
            if declared.fingerprint() != actual.fingerprint():
                raise PlanError(
                    f"node {node.name!r}: declares input {param}: "
                    f"{declared.__name__} but upstream {table!r} publishes "
                    f"{actual.__name__} "
                    f"(declared={declared.names()}, actual={actual.names()})")
            input_schemas[table] = actual
        report = check_node(input_schemas, node.output_schema,
                            casts=node.casts)
        # 3. static discharge (only for inspectable nodes).
        elided = provable_postconditions(
            input_schemas, node.output_schema,
            inspectable=node.inspectable,
            null_preserving=node.null_preserving)
        # level scheduling: a node runs one wave after its deepest
        # upstream node; source-only nodes form wave 0 (DESIGN.md §8).
        wave = max((node_wave[t] + 1 for t in node.inputs.values()
                    if t in node_wave), default=0)
        node_wave[node.name] = wave
        stats = None
        if table_stats:
            stats = {t: table_stats[t] for t in node.inputs.values()
                     if t in table_stats} or None
        # 4. logical lowering (inspectable declarative nodes only).
        logical = (node.logical_tree()
                   if hasattr(node, "logical_tree") else None)
        steps.append(PlanStep(node=node, report=report,
                              elided_null_checks=elided, wave=wave,
                              input_stats=stats, logical=logical))
        published[node.name] = node.output_schema

    return Plan(pipeline_name=pipeline.name,
                code_hash=pipeline.code_hash(),
                steps=tuple(steps),
                source_schemas=dict(pipeline.source_schemas))
