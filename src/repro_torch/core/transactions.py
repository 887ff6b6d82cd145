"""Transactional pipeline runs (paper §3.3).

The run protocol, verbatim from the paper — for target branch ``B``:

1. automatically create a new transactional branch ``B'`` from ``B``;
2. write the DAG tables into ``B'`` (one multi-table atomic commit for a
   whole pipeline via :meth:`TransactionalRun.write_tables`);
3. run data tests / user-defined verifiers on ``B'``;
4. only if no code or data error is raised, merge ``B'`` back into ``B``
   and delete it.

**Publication is concurrency-correct** (DESIGN.md §7): ``begin()``
captures the target head and ``commit()`` merges with an optimistic CAS
(``expected_head``). If the target moved, the silent-three-way-merge
hazard — publishing a combined state *no verifier ever saw*, the exact
counterexample the paper's Alloy model warns about around transactional
branch visibility — is closed by **rebase-and-revalidate**: the
transactional branch is rebased onto the new head, **every registered
verifier re-runs against the rebased state**, and the CAS merge is
retried with bounded backoff. After ``max_publish_attempts`` the run
aborts with :class:`PublicationConflict`. The published commit is
therefore always a fast-forward of a branch head that the full verifier
set validated.

On failure the transactional branch is marked ABORTED and **preserved**
so the faulty intermediate assets can be queried for triage — but the
catalog's visibility rules guarantee it can never be merged (Fig. 4).

Every run is uniquely identified and pinned to the state of the lake
(start commit) and of the code (a content hash), giving the paper's
reproducibility story: ``registry.get_run(run_id)`` returns everything
needed to replay the run (Listing 6).
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
import uuid
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.catalog import Catalog, Commit, Visibility
from repro_torch.core.errors import (PublicationConflict, RefConflict,
                               TransactionAborted, TransactionError)
from repro_torch.core.hooks import fault_point
from repro_torch.core.store import ObjectStore, content_hash
from repro_torch.obs import build_manifest, get_recorder, store_manifest

__all__ = ["RunState", "RunRegistry", "TransactionalRun", "run_transaction"]

_NOOP_CTX = contextlib.nullcontext()


def _verifier_name(fn) -> str:
    return getattr(fn, "__name__", None) or type(fn).__name__


@dataclasses.dataclass(frozen=True)
class RunState:
    """Immutable record returned by a run (paper Listing 6).

    ``ref`` pins the state the run *read from* (the head at ``begin``);
    ``base_commit`` pins the head the run *published onto* — after a
    rebase these differ, and replaying the DAG at ``ref`` reproduces the
    run's outputs while ``final_commit``'s parent is ``base_commit``.
    """

    run_id: str
    ref: str                   # start commit id (pinned read state)
    code_hash: str             # content hash of the DAG code
    target_branch: str
    txn_branch: str
    status: str                # "running" | "committed" | "aborted"
    final_commit: str | None = None
    error: str | None = None
    started_at: float = 0.0
    finished_at: float | None = None
    verified_head: str | None = None   # branch head the verifiers validated
    publish_attempts: int = 0          # CAS attempts commit() needed
    base_commit: str | None = None     # head the run published onto


class RunRegistry:
    """run_id -> RunState bookkeeping (in the paper: control-plane DB)."""

    def __init__(self):
        self._runs: dict[str, RunState] = {}
        self._lock = threading.Lock()

    def record(self, state: RunState) -> None:
        with self._lock:
            self._runs[state.run_id] = state

    def get_run(self, run_id: str) -> RunState:
        with self._lock:
            try:
                return self._runs[run_id]
            except KeyError:
                raise TransactionError(
                    f"unknown run_id {run_id!r}") from None

    def runs(self) -> list[RunState]:
        with self._lock:
            return list(self._runs.values())


class TransactionalRun:
    """Context-managed implementation of the §3.3 protocol.

    Usage::

        with TransactionalRun(catalog, target="main", code=b"...") as txn:
            txn.write_table("parent", snap_p)
            txn.write_table("child", snap_c)
            txn.verify(lambda read: check_quality(read("child")))
        # exit: atomically merged into `main` (rebase-and-revalidate on
        # concurrent movement); on exception: aborted, branch preserved
        # as `txn.branch` with Visibility.ABORTED.
    """

    def __init__(self, catalog: Catalog, target: str, *,
                 code: bytes | str = b"", registry: RunRegistry | None = None,
                 run_id: str | None = None, author: str = "",
                 keep_branch_on_success: bool = False,
                 max_publish_attempts: int = 8,
                 publish_backoff_s: float = 0.001,
                 publish_backoff_cap_s: float = 0.05,
                 publish_retry_budget_s: float | None = None,
                 backoff: str = "decorrelated",
                 backoff_seed: int | str | None = None,
                 clock: Any | None = None):
        self.catalog = catalog
        self.target = target
        self.registry = registry
        self.author = author
        self.keep_branch_on_success = keep_branch_on_success
        self.max_publish_attempts = max_publish_attempts
        self.publish_backoff_s = publish_backoff_s
        self.publish_backoff_cap_s = publish_backoff_cap_s
        self.publish_retry_budget_s = publish_retry_budget_s
        if backoff not in ("decorrelated", "linear"):
            raise ValueError(
                f"backoff must be 'decorrelated' or 'linear', "
                f"got {backoff!r}")
        self.backoff = backoff
        self.run_id = run_id or f"run_{uuid.uuid4().hex[:12]}"
        # Seeded per run: the retry schedule is replayable (chaos tier)
        # yet decorrelated ACROSS runs — contending runs with distinct
        # run_ids never share a jitter sequence, so a thundering herd
        # of conflicting publishers spreads out instead of re-colliding
        # in lockstep the way the old `base * attempt` schedule did.
        self._backoff_rng = random.Random(
            backoff_seed if backoff_seed is not None else self.run_id)
        self._prev_backoff = 0.0
        self.backoff_spent_s = 0.0   # total injected sleep (fake or real)
        # Injectable clock (chaos: FakeClock) — anything with .sleep().
        self._sleep = clock.sleep if clock is not None else time.sleep
        code_bytes = code.encode() if isinstance(code, str) else code
        self.code_hash = content_hash(code_bytes)[:16]
        self.branch: str | None = None
        self.final_commit: Commit | None = None
        self.publish_attempts = 0
        self._start_commit: str | None = None
        self._target_head: str | None = None   # CAS token for publication
        self._verifiers: list[Callable[[Callable[[str], str]], Any]] = []
        self._verifier_heads: list[str | None] = []  # head each fn last saw
        self._executor: Callable[
            [Callable[[str], str], Callable[..., Any]], Any] | None = None
        self._needs_reexecution = False
        self._status = "created"
        self._started_at = 0.0
        # Flight recorder (DESIGN.md §14): the recorder active at
        # begin() owns this run's span tree; the "run" span stays open
        # across the begin()/commit() pair and its finished subtree is
        # anchored to the published commit as an audit manifest.
        self._rec = None
        self._run_span = None

    # ------------------------------------------------------------------
    def begin(self) -> "TransactionalRun":
        if self._status != "created":
            raise TransactionError(f"run {self.run_id} already begun")
        self._started_at = time.time()
        head = self.catalog.head(self.target)
        self._start_commit = head.id
        self._target_head = head.id   # publication CAS expects this head
        self.branch = f"txn/{self.run_id}"
        # step 1: system-created transactional branch
        self.catalog.create_branch(
            self.branch, self.target, visibility=Visibility.TXN,
            owner_run=self.run_id)
        # chaos: dying here abandons a fresh TXN branch (GC's problem)
        fault_point("txn.begin.post_branch", run_id=self.run_id,
                    branch=self.branch)
        self._status = "running"
        rec = get_recorder()
        if rec.enabled:
            self._rec = rec
            self._run_span = rec.start_span(
                "run", run_id=self.run_id, target=self.target,
                txn_branch=self.branch, start_commit=self._start_commit,
                code_hash=self.code_hash)
        self._record()
        return self

    # step 2: writes — isolated on the transactional branch
    def write_table(self, table: str, snapshot: str, *,
                    message: str = "") -> Commit:
        self._require_running()
        return self.catalog.write_table(
            self.branch, table, snapshot, message=message,
            author=self.author, run_id=self.run_id, _system=True)

    def write_tables(self, tables: Mapping[str, str], *,
                     message: str = "") -> Commit:
        """Write a whole DAG's outputs as ONE multi-table atomic commit."""
        self._require_running()
        return self.catalog.write_tables(
            self.branch, tables, message=message,
            author=self.author, run_id=self.run_id, _system=True)

    def read_table(self, table: str) -> str:
        """Read within the transaction (sees own writes, snapshot reads)."""
        self._require_running()
        return self.catalog.read_table(self.branch, table)

    # step 3: verifiers — run on B' before publication
    def verify(self, fn: Callable[[Callable[[str], str]], Any]) -> None:
        """Register (and immediately run) a verifier against B'.

        ``fn`` receives a reader ``read(table) -> snapshot`` bound to the
        transactional branch. Any exception aborts the run. The branch
        head the verifier observed is recorded; ``commit()`` re-runs
        every verifier whose observation is stale (writes after
        verification, or a rebase onto a moved target) so that no state
        is ever published unvalidated.
        """
        self._require_running()
        observed = self.catalog.head(self.branch).id
        self._verifiers.append(fn)
        self._verifier_heads.append(None)
        rec = get_recorder()
        try:
            if rec.enabled:
                with rec.span("verifier", fn=_verifier_name(fn),
                              head=observed, phase="initial") as sp:
                    fn(self.read_table)
                    sp.set(outcome="passed")
            else:
                fn(self.read_table)
        except Exception as e:
            self.abort(e)
            raise TransactionAborted(
                f"verifier failed: {e}", branch=self.branch, cause=e) from e
        self._verifier_heads[-1] = observed

    @property
    def verifier_heads(self) -> tuple[str | None, ...]:
        """Branch head each registered verifier last validated."""
        return tuple(self._verifier_heads)

    def set_executor(self, fn: Callable[
            [Callable[[str], str], Callable[..., Any]], Any]) -> None:
        """Register a re-execution hook run after every rebase.

        ``fn(read, write_tables)`` re-derives the run's outputs from the
        *rebased* branch state — with the engine's content-addressed
        cache, only nodes whose input snapshots actually moved execute
        (O(changed subgraph), not O(full DAG)) — and writes back only
        the snapshots that changed. It runs in :meth:`_revalidate`
        BEFORE the verifiers, so the verifier set always validates the
        recomputed state that will be published. Without it, a rebase
        past a concurrent update of a *source* table would publish
        outputs computed from the pre-rebase inputs.
        """
        self._require_running()
        self._executor = fn

    def _revalidate(self) -> str:
        """Re-run the registered executor (if a rebase made inputs
        stale) and then EVERY registered verifier against the current
        branch state; returns the branch head they all validated."""
        rec = get_recorder()
        reval_ctx = (rec.span("revalidate",
                              reexecute=bool(self._executor is not None
                                             and self._needs_reexecution),
                              verifiers=len(self._verifiers))
                     if rec.enabled else _NOOP_CTX)
        with reval_ctx:
            if self._executor is not None and self._needs_reexecution:
                try:
                    if rec.enabled:
                        with rec.span("reexecute"):
                            self._executor(self.read_table,
                                           self.write_tables)
                    else:
                        self._executor(self.read_table, self.write_tables)
                except TransactionAborted:
                    raise
                except Exception as e:
                    self.abort(e)
                    raise TransactionAborted(
                        f"re-execution after rebase failed: {e}",
                        branch=self.branch, cause=e) from e
            self._needs_reexecution = False
            observed = self.catalog.head(self.branch).id
            for fn in self._verifiers:
                try:
                    if rec.enabled:
                        with rec.span("verifier", fn=_verifier_name(fn),
                                      head=observed,
                                      phase="revalidate") as sp:
                            fn(self.read_table)
                            sp.set(outcome="passed")
                    else:
                        fn(self.read_table)
                except Exception as e:
                    self.abort(e)
                    raise TransactionAborted(
                        f"verifier failed on revalidation against "
                        f"{observed[:8]}: {e}",
                        branch=self.branch, cause=e) from e
            self._verifier_heads = [observed] * len(self._verifiers)
            return observed

    def _backoff_delay(self, attempt: int) -> float:
        """Next publication-retry sleep (DESIGN.md §15).

        ``decorrelated`` (default): seeded decorrelated-jitter
        exponential backoff — ``min(cap, U[base, 3·prev])`` — so
        conflicting publishers spread apart instead of re-colliding in
        lockstep; the sequence is replayable from the run's seed.
        ``linear`` keeps the old ``base · attempt`` schedule (the
        contended-publication benchmark's baseline).
        """
        base = self.publish_backoff_s
        if not base:
            return 0.0
        if self.backoff == "linear":
            return base * attempt
        prev = self._prev_backoff if self._prev_backoff else base
        delay = min(self.publish_backoff_cap_s,
                    self._backoff_rng.uniform(base, prev * 3.0))
        self._prev_backoff = delay
        return delay

    # step 4: atomic publication — CAS + rebase-and-revalidate
    def commit(self) -> Commit:
        self._require_running()
        rec = self._rec if self._rec is not None else get_recorder()
        attempt = 0
        while True:
            attempt += 1
            self.publish_attempts = attempt
            att_ctx = (rec.span("publication_attempt", attempt=attempt,
                                expected_head=self._target_head)
                       if rec.enabled else _NOOP_CTX)
            with att_ctx as att_span:
                # Never publish state the full verifier set did not
                # validate: if any verifier's observation is stale (a
                # write or a rebase happened after it ran), or a rebase
                # left the run's outputs possibly computed from moved
                # inputs, re-derive and re-run them all first.
                branch_head = self.catalog.head(self.branch).id
                if self._needs_reexecution or (
                        self._verifiers and any(
                            h != branch_head
                            for h in self._verifier_heads)):
                    branch_head = self._revalidate()
                # chaos: the CAS boundary — a delay here preempts this
                # publisher between verification and merge; a crash
                # abandons a fully-verified, unpublished TXN branch.
                fault_point("txn.commit.pre_merge", run_id=self.run_id,
                            attempt=attempt,
                            expected_head=self._target_head)
                try:
                    merged = self.catalog.merge(
                        self.branch, into=self.target, run_id=self.run_id,
                        message=f"txn commit {self.run_id}",
                        expected_head=self._target_head, _system=True)
                    # chaos: published but not yet acknowledged — a
                    # crash here is the lost-ack window: the commit is
                    # on the target, the TXN branch is orphaned, the
                    # registry still says "running". Recovery = GC.
                    fault_point("txn.commit.post_merge",
                                run_id=self.run_id, commit=merged.id)
                    if att_span is not None:
                        att_span.set(outcome="published",
                                     commit=merged.id)
                    break
                except RefConflict as e:
                    if rec.enabled:
                        actual = self.catalog.head(self.target).id
                        rec.event("ref_conflict", attempt=attempt,
                                  expected_head=self._target_head,
                                  actual_head=actual, target=self.target)
                        rec.metrics.counter(
                            "txn.publication.conflicts").inc()
                        if att_span is not None:
                            att_span.set(outcome="conflict")
                    if attempt >= self.max_publish_attempts:
                        self.abort(e)
                        raise PublicationConflict(
                            f"run {self.run_id}: target {self.target!r} "
                            f"kept moving; gave up after {attempt} "
                            f"publication attempts",
                            branch=self.branch, cause=e) from e
                    delay = self._backoff_delay(attempt)
                    if (self.publish_retry_budget_s is not None
                            and self.backoff_spent_s + delay
                            > self.publish_retry_budget_s):
                        self.abort(e)
                        raise PublicationConflict(
                            f"run {self.run_id}: publication retry "
                            f"budget "
                            f"({self.publish_retry_budget_s:g}s) "
                            f"exhausted after {attempt} attempts",
                            branch=self.branch, cause=e) from e
                    if delay:
                        self.backoff_spent_s += delay
                        if rec.enabled:
                            rec.event("backoff", attempt=attempt,
                                      delay_s=round(delay, 6),
                                      kind=self.backoff)
                        self._sleep(delay)
                    # Rebase onto the head we just observed — an
                    # immutable commit id, so the subsequent CAS
                    # publishes exactly the (re-verified) rebased state
                    # or conflicts again.
                    fault_point("txn.commit.pre_rebase",
                                run_id=self.run_id, attempt=attempt)
                    try:
                        new_head = self.catalog.head(self.target).id
                        if rec.enabled:
                            with rec.span("rebase",
                                          from_head=self._target_head,
                                          onto=new_head):
                                self.catalog.rebase(
                                    self.branch, new_head,
                                    run_id=self.run_id, _system=True)
                            rec.metrics.counter("txn.rebases").inc()
                        else:
                            self.catalog.rebase(
                                self.branch, new_head,
                                run_id=self.run_id, _system=True)
                        self._target_head = new_head
                        # the rebase may have moved this run's INPUT
                        # tables: the executor must re-derive before
                        # revalidation.
                        self._needs_reexecution = True
                    except Exception as e2:
                        self.abort(e2)
                        raise TransactionAborted(
                            f"publication failed: {e2}",
                            branch=self.branch, cause=e2) from e2
                    fault_point("txn.commit.post_rebase",
                                run_id=self.run_id, attempt=attempt,
                                onto=self._target_head)
                except Exception as e:
                    self.abort(e)
                    raise TransactionAborted(
                        f"publication failed: {e}", branch=self.branch,
                        cause=e) from e
        self._status = "committed"
        self.final_commit = merged
        if not self.keep_branch_on_success:
            self.catalog.delete_branch(self.branch, _system=True)
        else:
            # the branch's state is now published: release it to users
            self.catalog.mark(self.branch, Visibility.USER, _system=True)
        self._record(final_commit=merged.id)
        self._finish_trace(merged)
        return merged

    def abort(self, error: BaseException | str | None = None) -> None:
        """Mark the transactional branch ABORTED; keep it for triage."""
        if self._status != "running":
            return
        self._status = "aborted"
        # the branch stays: "reachable by any user for debugging and
        # inspection" — but Visibility.ABORTED means it can never merge.
        self.catalog.mark(self.branch, Visibility.ABORTED, _system=True)
        self._record(error=str(error) if error else None)
        # Close the run span (aborted runs leave NO manifest: the
        # anchoring rule keys manifests by published commit id, and an
        # aborted run published nothing — the trace stays inspectable
        # on the recorder itself).
        if self._run_span is not None:
            self._run_span.set(status="aborted",
                               publish_attempts=self.publish_attempts,
                               error=str(error) if error else None)
            self._rec.end_span(self._run_span)
            self._run_span = None

    def _finish_trace(self, merged: Commit) -> None:
        """Seal the run span and anchor its subtree to ``merged``.

        The manifest is written to the catalog's own object store and
        named ``runmanifest/<commit_id>`` (see ``repro_torch.obs.manifest``),
        so ``Catalog.run_manifest(commit_id)`` can audit any published
        state post-hoc. Purely observational: written AFTER the merge
        ref moved, never read by commit resolution or cache keys.
        """
        if self._run_span is None:
            return
        rec, span = self._rec, self._run_span
        self._run_span = None
        span.set(status="committed", commit=merged.id,
                 publish_attempts=self.publish_attempts)
        rec.end_span(span)
        subtree = getattr(rec, "subtree", None)
        if subtree is None:     # custom recorder without introspection
            return
        doc = build_manifest(
            span, subtree(span), commit_id=merged.id, run_id=self.run_id,
            metrics=rec.metrics.snapshot(),
            orphan_events=rec.orphan_events())
        try:
            store_manifest(self.catalog.store, merged.id, doc)
        except Exception:
            # observational means observational: the commit is already
            # published, and a failed audit write must not turn a
            # successful run into a dead one. The commit simply reads
            # back as untraced (run_manifest -> None).
            rec.event("manifest_write_failed", commit=merged.id,
                      run_id=self.run_id)

    # ------------------------------------------------------------------
    def __enter__(self) -> "TransactionalRun":
        return self.begin()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.commit()
            return False
        # Only ordinary Exceptions abort (mark the branch for triage).
        # BaseExceptions — InjectedCrash, KeyboardInterrupt, SystemExit
        # — model process death: a dead process runs no cleanup, and
        # the dangling TXN branch is exactly what Catalog.gc collects.
        if not isinstance(exc, TransactionAborted) \
                and isinstance(exc, Exception):
            self.abort(exc)
        return False  # propagate

    # ------------------------------------------------------------------
    def _require_running(self) -> None:
        if self._status != "running":
            raise TransactionError(
                f"run {self.run_id} is {self._status}, not running")

    def _record(self, final_commit: str | None = None,
                error: str | None = None) -> None:
        if self.registry is None:
            return
        heads = {h for h in self._verifier_heads if h is not None}
        self.registry.record(RunState(
            run_id=self.run_id, ref=self._start_commit or "",
            code_hash=self.code_hash, target_branch=self.target,
            txn_branch=self.branch or "", status=self._status,
            final_commit=final_commit, error=error,
            started_at=self._started_at,
            finished_at=(time.time()
                         if self._status in ("committed", "aborted")
                         else None),
            verified_head=(heads.pop() if len(heads) == 1 else None),
            publish_attempts=self.publish_attempts,
            base_commit=self._target_head))


def run_transaction(
    catalog: Catalog,
    target: str,
    writes: Mapping[str, str] | Sequence[tuple[str, str]],
    *,
    verifiers: Sequence[Callable[[Callable[[str], str]], Any]] = (),
    code: bytes | str = b"",
    registry: RunRegistry | None = None,
) -> Commit:
    """One-shot functional form of the protocol.

    Returns the actual merged :class:`Commit` from ``txn.commit()`` —
    NOT ``catalog.head(target)`` after the fact, which may already
    reflect a later concurrent run.
    """
    items = writes.items() if isinstance(writes, Mapping) else writes
    with TransactionalRun(catalog, target, code=code,
                          registry=registry) as txn:
        txn.write_tables(dict(items), message=f"txn {txn.run_id}")
        for v in verifiers:
            txn.verify(v)
    assert txn.final_commit is not None
    return txn.final_commit
