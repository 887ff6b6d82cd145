"""The worker: execute a validated Plan inside a transactional run.

Paper Figure 1 moments (2)→(3): the control plane hands a :class:`Plan`
to a worker; the worker reads source tables *from the pinned start
commit* (snapshot reads), executes the plan's dependency **waves**
concurrently through :class:`repro_torch.core.engine.PlanExecutor` — skipping
any node whose content-addressed cache entry already names its output —
validates each output against its declared schema **before** persisting
(moment 3), then writes the run's outputs to the transactional branch
as ONE multi-table atomic commit, registers user verifiers on the
transaction (step 3 of §3.3), and publishes via the CAS +
rebase-and-revalidate protocol — all outputs of the run or none, and
``log()`` shows one commit per run, not one per node. On a publication
rebase the engine re-executes ONLY the nodes whose input snapshots
moved (DESIGN.md §8). If the run fails mid-DAG, exactly the validated
outputs are flushed to the (then ABORTED) branch so they remain
queryable for triage.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Mapping, Sequence

from repro_torch.core.catalog import Catalog
from repro_torch.core.engine import NodeCache, PlanExecutor
from repro_torch.core.errors import ExecutionError, TransactionAborted
from repro_torch.core.planner import Plan
from repro_torch.core.quality import Verifier
from repro_torch.core.transactions import RunRegistry, RunState, TransactionalRun
from repro_torch.data.tables import Table

__all__ = ["RunResult", "QueryResult", "Client"]

_NOOP_CTX = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class RunResult:
    state: RunState
    tables: Mapping[str, str]  # table -> snapshot key written by this run
    executed: tuple[str, ...] = ()  # nodes actually run (cache misses)
    cached: tuple[str, ...] = ()    # nodes satisfied from the cache
    # nodes re-executed per publication rebase (empty: published on the
    # first CAS attempt). All zeros = every rebase was fully incremental.
    rebase_reexecutions: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Result of one :meth:`Client.sql` query (read-only: no commit).

    ``executed``/``cached`` expose the engine's verdict — a repeated
    query at the same commit is a pure cache hit (``executed == ()``),
    because the content-addressed key binds the compiled logical tree
    to the pinned input snapshots, never to the query text.
    """

    table: Table
    plan: "object"                 # the optimized Plan (EXPLAIN source)
    schema: type                   # inferred output contract
    snapshot: str                  # content-addressed result snapshot
    commit_id: str                 # the pinned commit queried
    query: str
    executed: tuple[str, ...] = ()
    cached: tuple[str, ...] = ()

    def describe(self, *, analyze: bool = False) -> str:
        """EXPLAIN: the optimized plan with query text and rewrite
        provenance. ``analyze=True`` adds per-step actuals (the query
        already executed, so runtime is always present here)."""
        return self.plan.describe(analyze=analyze)

    def fingerprint(self) -> str:
        return self.table.fingerprint()


class Client:
    """The user-facing API of paper Listing 6.

    Wraps a catalog + object store + run registry and exposes
    ``create_branch`` / ``run`` / ``merge`` / ``get_run``.
    """

    def __init__(self, catalog: Catalog | None = None,
                 registry: RunRegistry | None = None):
        self.catalog = catalog if catalog is not None else Catalog()
        self.registry = registry if registry is not None else RunRegistry()
        self.store = self.catalog.store
        # shared across this client's runs; persisted via store refs so
        # clients over one (file-backed) store share entries too.
        self.node_cache = NodeCache(self.store)
        # SQL front door memos, keyed by snapshot: discovered contracts
        # (manifest-only reads) and row-count stats — so a repeated
        # query at an unchanged commit touches no column data at all.
        self._sql_schemas: dict[tuple[str, str], type] = {}
        self._sql_stats: dict[str, object] = {}

    # -- Git-for-data surface (Listing 6) --------------------------------
    def create_branch(self, name: str, from_ref: str = "main", **kw):
        return self.catalog.create_branch(name, from_ref, **kw)

    def merge(self, source: str, into: str = "main", **kw):
        return self.catalog.merge(source, into=into, **kw)

    def get_run(self, run_id: str) -> RunState:
        return self.registry.get_run(run_id)

    def tag(self, name: str, ref: str) -> str:
        return self.catalog.tag(name, ref)

    # -- data access -------------------------------------------------------
    def write_source_table(self, branch: str, name: str, table: Table,
                           message: str = "") -> str:
        snap = table.to_blobs(self.store)
        self.catalog.write_table(branch, name, snap, message=message)
        return snap

    def read_table(self, ref: str, name: str) -> Table:
        snap = self.catalog.read_table(ref, name)
        return Table.from_blobs(self.store, snap)

    # -- SQL front door (DESIGN.md §13) ------------------------------------
    def _discover_schema(self, table: str, snapshot: str) -> type:
        from repro_torch.sql.discovery import schema_from_snapshot
        key = (table, snapshot)
        if key not in self._sql_schemas:
            self._sql_schemas[key] = schema_from_snapshot(
                self.store, snapshot, table)
        return self._sql_schemas[key]

    def _snapshot_stats(self, snapshot: str):
        """Row-count stats from one column blob (not the whole table),
        memoized by snapshot so repeated queries at an unchanged commit
        never touch column data."""
        from repro_torch.exec.stats import TableStats
        if snapshot not in self._sql_stats:
            manifest = self.store.get_json(snapshot)
            n = 0
            for m in manifest["columns"].values():
                n = len(self.store.get_array(m["values"]))
                break
            self._sql_stats[snapshot] = TableStats(n_rows=n)
        return self._sql_stats[snapshot]

    def sql(self, query: str, ref: str = "main", *,
            optimizer_passes: "Sequence[str] | None" = None,
            cache: bool = True) -> QueryResult:
        """Compile and execute one SQL SELECT against a pinned ref.

        Table discovery happens at ``ref``'s head commit: every catalog
        table is visible, its contract inferred from the snapshot
        manifest (dtypes + nullability; no column data is read to
        compile). Unknown tables/columns are compile-time errors naming
        the ref, with a nearest-name suggestion. The compiled logical
        tree flows through the standard pipeline: ``plan()`` with
        row-count stats, ``optimize()`` (``optimizer_passes=()`` skips
        optimization; ``None`` = the default passes), the stats-driven
        ``torch_auto`` backend, and the content-addressed :class:`NodeCache`
        — so re-running any spelling of the same query at the same
        commit executes zero nodes. Reads are snapshot-isolated against
        the resolved commit; nothing is committed.
        """
        from repro_torch.core.dag import Pipeline
        from repro_torch.core.planner import plan as plan_fn
        from repro_torch.obs import get_recorder
        from repro_torch.optimizer import optimize
        from repro_torch.sql.compiler import compile_query

        rec = get_recorder()
        sql_ctx = (rec.span("sql", ref=ref, query=query)
                   if rec.enabled else _NOOP_CTX)
        with sql_ctx as sql_span:
            commit = self.catalog.head(ref)
            if sql_span is not None:
                sql_span.set(commit=commit.id)
            context = f"ref {ref!r} (commit {commit.id})"
            schemas = {t: self._discover_schema(t, snap)
                       for t, snap in commit.tables.items()}
            name = "query"
            while name in commit.tables:
                name += "_"
            compiled = compile_query(query, name=name, schemas=schemas,
                                     context=context)

            pipeline = Pipeline("sql")
            for t in compiled.tables:
                pipeline.source(t, schemas[t])
            pipeline.add(compiled.node)
            stats = {t: self._snapshot_stats(commit.tables[t])
                     for t in compiled.tables}
            pl = plan_fn(pipeline, table_stats=stats)
            if optimizer_passes is None:
                pl = optimize(pl)
            elif optimizer_passes:
                pl = optimize(pl, optimizer_passes)

            engine = PlanExecutor(pl, self.store,
                                  cache=self.node_cache if cache else None)
            outcome = engine.execute(commit.tables.__getitem__)
            snap = outcome.snapshots[name]
            result = QueryResult(
                table=Table.from_blobs(self.store, snap),
                plan=pl, schema=compiled.output_schema, snapshot=snap,
                commit_id=commit.id, query=query,
                executed=outcome.executed, cached=outcome.cached)
            if sql_span is not None:
                sql_span.set(rows_out=result.table.num_rows,
                             executed=len(outcome.executed),
                             cached=len(outcome.cached))
            return result

    def _table_verifier(self, table: str,
                        checks: Sequence[Verifier]
                        ) -> Callable[[Callable[[str], str]], None]:
        """Adapt table-level quality checks to a txn verifier: re-reads
        the table from the (possibly rebased) branch so revalidation
        after a rebase checks exactly the state being published."""
        def run_checks(read: Callable[[str], str]) -> None:
            t = Table.from_blobs(self.store, read(table))
            for check in checks:
                check(t)
        return run_checks

    # -- the run API (§3.3 protocol over a full DAG plan) --------------------
    def run(self, plan: Plan, ref: str = "main", *,
            verifiers: Mapping[str, Sequence[Verifier]] | None = None,
            dry_run: bool = False,
            fail_after: str | None = None,
            max_publish_attempts: int | None = None,
            max_workers: int | None = None,
            cache: bool = True) -> RunResult:
        """Execute ``plan`` transactionally against branch ``ref``.

        Waves of independent nodes run concurrently; nodes whose
        content-addressed cache key already names an output snapshot are
        skipped (their snapshot is reused after re-validating the
        contract). ``verifiers`` maps table name -> quality checks run
        at step (3); they are registered on the transaction so
        publication can re-run them against a rebased state (DESIGN.md
        §7), and a rebase additionally re-executes the nodes whose input
        snapshots moved (DESIGN.md §8). ``fail_after`` (testing hook)
        injects a failure after the named node completes, to exercise
        the abort path deterministically. ``max_publish_attempts``
        bounds the CAS retry loop under heavy concurrent publication
        (default: TransactionalRun's). ``max_workers`` caps wave
        concurrency (1 = sequential); ``cache=False`` forces every node
        to execute.
        """
        if dry_run:
            # plan is already validated; nothing to execute.
            return RunResult(
                state=RunState(run_id="dry", ref=self.catalog.head(ref).id,
                               code_hash=plan.code_hash, target_branch=ref,
                               txn_branch="", status="dry"),
                tables={})

        verifiers = dict(verifiers or {})
        txn_kw = {}
        if max_publish_attempts is not None:
            txn_kw["max_publish_attempts"] = max_publish_attempts
        txn = TransactionalRun(self.catalog, ref, code=plan.code_hash,
                               registry=self.registry, **txn_kw)
        txn.begin()
        engine = PlanExecutor(plan, self.store,
                              cache=self.node_cache if cache else None,
                              max_workers=max_workers)
        source_names = plan.source_tables()

        def branch_sources() -> Callable[[str], str]:
            # snapshot reads: ALL sources resolve against one commit of
            # the txn branch (forked from the start commit, rebased only
            # by this run) — a consistent read set even if `ref` moves.
            pinned = self.catalog.read_tables(txn.branch, source_names)
            return pinned.__getitem__

        written: dict[str, str] = {}
        rebase_reexecutions: list[int] = []
        try:
            outcome = engine.execute(branch_sources(),
                                     fail_after=fail_after)
            written.update(outcome.snapshots)
            # ONE atomic commit for the whole DAG (log reflects runs) —
            # writing only snapshots that differ from the branch state,
            # so a fully-cached re-run publishes no new commit at all.
            current = self.catalog.tables(txn.branch)
            changed = {t: s for t, s in written.items()
                       if current.get(t) != s}
            txn.write_tables(
                changed,
                message=f"run {plan.pipeline_name} "
                        f"({len(written)} tables)")
            # step (3): quality verifiers on B', re-run on rebase.
            for table, checks in verifiers.items():
                if table in written:
                    txn.verify(self._table_verifier(table, checks))

            def reexecute(read: Callable[[str], str],
                          write_tables: Callable[..., None]) -> None:
                # after a rebase: re-derive from the rebased branch.
                # Unchanged inputs hit the cache (0 node executions);
                # only the changed subgraph runs. Write back only moved
                # snapshots, keeping the branch delta minimal.
                oc = engine.execute(branch_sources())
                cur = self.catalog.tables(txn.branch)
                delta = {t: s for t, s in oc.snapshots.items()
                         if cur.get(t) != s}
                if delta:
                    write_tables(
                        delta,
                        message=f"recompute {sorted(delta)} after rebase")
                written.update(oc.snapshots)
                rebase_reexecutions.append(len(oc.executed))

            txn.set_executor(reexecute)
            txn.commit()
        except ExecutionError as e:
            # flush EXACTLY the validated outputs (earlier waves + the
            # failing wave's validated siblings, in plan order) so the
            # ABORTED branch holds them for triage (§3.3 "preserved").
            if e.partial:
                try:
                    txn.write_tables(
                        e.partial, message="partial outputs before abort")
                except Exception:      # pragma: no cover - abort anyway
                    pass
            cause = e.cause or e
            txn.abort(cause)
            raise TransactionAborted(
                f"run {txn.run_id} aborted: {cause}", branch=txn.branch,
                cause=cause) from e
        except TransactionAborted:
            raise
        except Exception as e:         # pragma: no cover - safety net
            txn.abort(e)
            raise TransactionAborted(
                f"run {txn.run_id} aborted: {e}", branch=txn.branch,
                cause=e) from e
        return RunResult(state=self.registry.get_run(txn.run_id),
                         tables=written,
                         executed=outcome.executed,
                         cached=outcome.cached,
                         rebase_reexecutions=tuple(rebase_reexecutions))
