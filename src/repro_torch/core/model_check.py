"""Executable port of the paper's Alloy model (§4, Appendix B).

The Alloy signatures map 1:1 onto the real implementation, so model
checking here exercises the *actual* catalog code rather than a toy:

=============  =====================================================
Alloy          here
=============  =====================================================
``Table``      table name (str)
``Snapshot``   snapshot id (str) — fresh per write, tagged by run
``Commit``     :class:`repro_torch.core.catalog.Commit` (tables, parents)
``Branch``     catalog branch (movable head)
``createTable``:meth:`Catalog.write_table` (the only mutating op)
``Run``        :class:`ModelRun` (pipeline plan, idx, lastCommit)
=============  =====================================================

Two system variants:

- ``guarded=True``  — the shipped system: aborted transactional branches
  get :class:`Visibility.ABORTED` (not mergeable, reuse quarantined).
- ``guarded=False`` — the pre-fix system of Fig. 4: an aborted branch is
  left as an ordinary USER branch, so other actors can branch off it and
  merge back.

and two publication variants:

- ``publication="rebase"`` — the shipped CAS + rebase-and-revalidate
  protocol (DESIGN.md §7): a run publishes with ``expected_head``; on
  conflict it rebases its branch onto the new head and *re-verifies*
  before retrying.
- ``publication="stale"``  — the pre-fix protocol: a plain three-way
  merge with no CAS, which can silently publish a combined state no
  verifier ever observed when the target moved after ``begin``.

The **global consistency** predicate formalizes Fig. 3/4: a ref is *torn
with respect to run r* iff it exposes a strict, non-empty subset of r's
published tables (partial publication), or any table of an aborted run.
The **verified publication** predicate (:meth:`stale_publications`)
formalizes the §3.3 concurrency invariant: the commit a run publishes
must carry exactly the table state its verifiers last validated.
Hypothesis stateful tests in ``tests/test_model_check.py`` search traces:
the unguarded/stale models reach bad states (which makes the model
adequate); the guarded/rebase models must never.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Literal, Sequence

from repro_torch.core.catalog import Catalog, Visibility
from repro_torch.core.errors import (CatalogError, RefConflict, ReproError,
                                     VisibilityError)

__all__ = ["ModelRun", "LakehouseModel"]


@dataclasses.dataclass
class ModelRun:
    """Alloy's ``Run``: a pipeline (seq Table) + progress counter."""

    run_id: str
    plan: tuple[str, ...]              # sequence of tables to write
    mode: Literal["direct", "txn"]
    target: str
    idx: int = 0                       # next step to execute
    status: str = "running"            # running | committed | aborted
    branch: str | None = None          # txn branch (txn mode)
    written: dict[str, str] = dataclasses.field(default_factory=dict)
    start_head: str | None = None      # target head at begin (CAS token)
    verified_tables: dict[str, str] | None = None  # state verifiers saw
    published_commit: str | None = None            # commit the merge made

    @property
    def done(self) -> bool:
        return self.idx >= len(self.plan)


class LakehouseModel:
    """Driveable state machine over the real catalog."""

    def __init__(self, *, guarded: bool = True,
                 publication: Literal["rebase", "stale"] = "rebase"):
        self.catalog = Catalog()
        self.guarded = guarded
        self.publication = publication
        self._runs: dict[str, ModelRun] = {}
        self._fresh = itertools.count()
        self._branch_counter = itertools.count()
        self._gc_violations: list[tuple[str, str]] = []

    # ------------------------------------------------------------------
    # Run lifecycle (Alloy: begin / step / finish / fail)
    # ------------------------------------------------------------------
    def begin_run(self, plan: Sequence[str], *, target: str = "main",
                  mode: Literal["direct", "txn"] = "txn") -> ModelRun:
        rid = f"r{next(self._fresh)}"
        run = ModelRun(run_id=rid, plan=tuple(plan), mode=mode,
                       target=target)
        run.start_head = self.catalog.head(target).id
        if mode == "txn":
            run.branch = f"txn/{rid}"
            self.catalog.create_branch(run.branch, target,
                                       visibility=Visibility.TXN,
                                       owner_run=rid)
        self._runs[rid] = run
        return run

    def step_run(self, run: ModelRun) -> None:
        """Alloy: apply ``createTable`` to the next planned table."""
        assert run.status == "running" and not run.done
        table = run.plan[run.idx]
        snap = f"{table}@{run.run_id}#{run.idx}"
        branch = run.branch if run.mode == "txn" else run.target
        self.catalog.write_table(branch, table, snap, run_id=run.run_id,
                                 _system=(run.mode == "txn"))
        run.written[table] = snap
        run.idx += 1

    def finish_run(self, run: ModelRun) -> None:
        assert run.status == "running" and run.done
        if run.mode == "txn":
            # Alloy's `verify`: record the exact table state the run's
            # verifiers observed on B' at publication time.
            run.verified_tables = dict(self.catalog.tables(run.branch))
            if self.publication == "stale":
                # pre-fix: a plain merge — if the target moved after
                # begin, this silently three-way-merges a combined state
                # NO verifier ever saw.
                merged = self.catalog.merge(run.branch, into=run.target,
                                            run_id=run.run_id,
                                            _system=True)
            else:
                merged = self._publish_rebase(run)
            run.published_commit = merged.id
            self.catalog.delete_branch(run.branch, _system=True)
        run.status = "committed"

    def _publish_rebase(self, run: ModelRun):
        """The shipped protocol: CAS merge; on conflict rebase onto the
        observed head and re-verify before retrying."""
        expected = run.start_head
        while True:
            try:
                return self.catalog.merge(
                    run.branch, into=run.target, run_id=run.run_id,
                    expected_head=expected, _system=True)
            except RefConflict:
                new_head = self.catalog.head(run.target).id
                self.catalog.rebase(run.branch, new_head,
                                    run_id=run.run_id, _system=True)
                # re-verify: the verifiers now validate the rebased state
                run.verified_tables = dict(
                    self.catalog.tables(run.branch))
                expected = new_head

    def fail_run(self, run: ModelRun) -> None:
        """Mid-run failure. Direct mode just stops (torn!); txn aborts."""
        assert run.status == "running"
        run.status = "aborted"
        if run.mode == "txn":
            if self.guarded:
                self.catalog.mark(run.branch, Visibility.ABORTED,
                                  _system=True)
            else:
                # pre-fix system: the dangling branch looks like any other
                # branch (the Fig. 4 hazard).
                self.catalog.mark(run.branch, Visibility.USER,
                                  _system=True)

    def abandon_run(self, run: ModelRun) -> None:
        """The owning agent walks away (or dies) mid-run: no commit, no
        abort — the TXN branch dangles with its owner gone. This is the
        debris :meth:`gc` exists to collect."""
        assert run.status == "running"
        run.status = "abandoned"

    # ------------------------------------------------------------------
    # Garbage collection (DESIGN.md §15)
    # ------------------------------------------------------------------
    def live_run_ids(self) -> frozenset[str]:
        """Alloy's liveness relation: runs still executing own their
        transactional branches."""
        return frozenset(r.run_id for r in self._runs.values()
                         if r.status == "running")

    def gc(self, *, unsafe: bool = False) -> list[str]:
        """Collect transactional debris; returns collected branch names.

        The safe variant is the shipped :meth:`Catalog.gc` driven by
        the model's liveness relation. The ``unsafe`` variant is the
        pre-fix janitor the adequacy tests need: it deletes EVERY
        TXN/ABORTED branch with no liveness or pin check — the
        "cron job that cleans old branches" a naive lakehouse grows.
        Either way, any collection of a branch whose owner is still
        running, or whose head a reader has pinned, is recorded and
        surfaced by :meth:`collected_live_branches`.
        """
        heads: dict[str, tuple[str, str | None]] = {}
        vis_of: dict[str, Visibility] = {}
        for name in self.catalog.branches():
            info = self.catalog.branch_info(name)
            heads[name] = (info.head, info.owner_run)
            vis_of[name] = info.visibility
        if unsafe:
            collected = []
            for name in heads:
                if vis_of[name] in (Visibility.TXN, Visibility.ABORTED):
                    self.catalog.delete_branch(name, _system=True)
                    collected.append(name)
        else:
            report = self.catalog.gc(live_runs=self.live_run_ids(),
                                     grace_s=0.0)
            collected = [name for name, _reason in report.collected]
        live = self.live_run_ids()
        pinned = self.catalog.pinned()
        for name in collected:
            head, owner = heads[name]
            if owner is not None and owner in live:
                self._gc_violations.append(
                    (name, f"collected while owner {owner!r} was live"))
            if head in pinned:
                self._gc_violations.append(
                    (name, "collected while its head was pinned"))
        return collected

    def pin_branch(self, ref: str) -> str:
        """A reader pins the state it is serving/triaging from."""
        return self.catalog.pin(ref)

    def collected_live_branches(self) -> list[tuple[str, str]]:
        """The GC safety predicate: collections that destroyed state a
        live run or a pinned reader still owned. Must stay empty for
        the shipped GC under every schedule; the unsafe janitor
        populates it (adequacy)."""
        return list(self._gc_violations)

    # ------------------------------------------------------------------
    # Arbitrary-actor operations (the agent in Fig. 4)
    # ------------------------------------------------------------------
    def actor_branch(self, from_ref: str, *,
                     allow_reuse: bool = False) -> str:
        name = f"b{next(self._branch_counter)}"
        self.catalog.create_branch(name, from_ref, allow_reuse=allow_reuse)
        return name

    def actor_write(self, branch: str, table: str) -> str:
        snap = f"{table}@actor#{next(self._fresh)}"
        self.catalog.write_table(branch, table, snap)
        return snap

    def actor_merge(self, source: str, into: str = "main") -> None:
        self.catalog.merge(source, into=into)

    # ------------------------------------------------------------------
    # Global consistency predicate (Fig. 3/4)
    # ------------------------------------------------------------------
    def torn_runs(self, ref: str = "main") -> list[str]:
        """Runs w.r.t. which ``ref`` is globally inconsistent."""
        tables = self.catalog.tables(ref)
        torn = []
        for run in self._runs.values():
            if not run.written:
                continue
            visible = {t for t, s in run.written.items()
                       if tables.get(t) == s}
            if run.status == "committed":
                continue  # committed runs may be partially overwritten later
            # aborted / still-running runs: NO table of theirs may be
            # visible on a published ref; partial visibility = torn.
            if visible:
                torn.append(run.run_id)
        return torn

    def is_consistent(self, ref: str = "main") -> bool:
        return not self.torn_runs(ref)

    # ------------------------------------------------------------------
    # Concurrent-publication predicate (DESIGN.md §7)
    # ------------------------------------------------------------------
    def stale_publications(self) -> list[str]:
        """Runs whose published commit carries table state their
        verifiers never validated.

        This is the §3.3 concurrency invariant: the commit a run's merge
        creates (or fast-forwards to) must equal, table for table, the
        state of the transactional branch at the last verifier pass.
        A plain three-way merge against a moved target violates it; the
        rebase-and-revalidate protocol makes it unfalsifiable.
        """
        out = []
        for run in self._runs.values():
            if run.published_commit is None or run.verified_tables is None:
                continue
            published = dict(
                self.catalog.commit(run.published_commit).tables)
            if published != run.verified_tables:
                out.append(run.run_id)
        return out

    def publications_verified(self) -> bool:
        return not self.stale_publications()
