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

import dataclasses
from typing import Callable, Mapping, Sequence

from repro_torch.core.catalog import Catalog
from repro_torch.core.engine import NodeCache, PlanExecutor
from repro_torch.core.errors import ExecutionError, TransactionAborted
from repro_torch.core.planner import Plan
from repro_torch.core.quality import Verifier
from repro_torch.core.transactions import RunRegistry, RunState, TransactionalRun
from repro_torch.data.tables import Table

__all__ = ["RunResult", "Client"]


@dataclasses.dataclass(frozen=True)
class RunResult:
    state: RunState
    tables: Mapping[str, str]  # table -> snapshot key written by this run
    executed: tuple[str, ...] = ()  # nodes actually run (cache misses)
    cached: tuple[str, ...] = ()    # nodes satisfied from the cache
    # nodes re-executed per publication rebase (empty: published on the
    # first CAS attempt). All zeros = every rebase was fully incremental.
    rebase_reexecutions: tuple[int, ...] = ()


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
    def sql(self, query: str, ref: str = "main", **kw):
        """Not ported yet: the SQL front door needs ``repro_torch.sql``
        and ``repro_torch.optimizer``, which come with the slice after
        the partitioned join."""
        raise NotImplementedError(
            "Client.sql is not ported yet: it waits for the slice that "
            "ports repro.sql and repro.optimizer; build declarative "
            "nodes with Pipeline.sql and run them with Client.run")

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
