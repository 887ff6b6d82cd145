"""Agent-swarm stress harness (DESIGN.md §15).

Drives many concurrent :class:`~repro_torch.core.transactions.TransactionalRun`
agents against ONE catalog under an adversarial, seeded schedule:
contended hot-table publications (forcing mid-run rebases),
contract-violating writes, abandoned transactional branches, simulated
crashes at publication seams (via an active :class:`~repro_torch.chaos.faults.
FaultPlan`), quarantine-reuse of aborted branches, and a janitor
running :meth:`Catalog.gc` concurrently with live publications.

Everything an agent *intends* is decided by ``random.Random`` streams
keyed on ``(seed, agent, run)`` — replaying a seed replays the same
mix of behaviors, tables, and fault decisions; thread interleaving
varies, but the invariants :func:`repro_torch.chaos.check.check_swarm`
asserts are schedule-independent, so a red seed is a deterministic
reproduction of a real protocol bug, not of one lucky schedule.

Liveness protocol (GC soundness): an agent registers its run id in the
shared live set BEFORE ``begin()`` creates the TXN branch, and
``Catalog.gc`` snapshots the live view under the catalog lock — so the
janitor can run with ``grace_s=0`` and still never observe a live
run's branch without its owner. An agent that crashes or abandons
deregisters (its heartbeat stops), which is exactly what makes its
debris collectable.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Any, Sequence

from repro_torch.chaos.clock import FakeClock
from repro_torch.chaos.faults import (FaultPlan, FaultRule, FaultyStore,
                                     fault_injection)
from repro_torch.core.catalog import Catalog, GCReport
from repro_torch.core.errors import (BranchNotFound, CatalogError,
                                     MergeConflict, RefConflict,
                                     TransactionAborted, VisibilityError)
from repro_torch.core.hooks import InjectedCrash, InjectedFault
from repro_torch.core.store import MemoryStore, ObjectStore
from repro_torch.core.transactions import RunRegistry, TransactionalRun

__all__ = ["SwarmConfig", "AgentRecord", "SwarmResult", "run_swarm"]


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    """One reproducible swarm experiment. Everything derives from
    ``seed``; behavior probabilities are cumulative draws per run."""

    n_agents: int = 8
    runs_per_agent: int = 3
    seed: int | str = 0
    hot_tables: int = 2          # shared table pool driving contention
    p_contended: float = 0.35    # write a hot table (rebase pressure)
    p_multi: float = 0.2         # multi-table atomic run (2-3 tables)
    p_violate: float = 0.1       # contract-violating write -> abort
    p_abandon: float = 0.08      # walk away mid-run (orphan TXN branch)
    p_reuse: float = 0.12        # quarantine-reuse an aborted branch
    gc_every: int = 0            # janitor gc per N completions (0 = off)
    gc_grace_s: float = 0.0      # grace for the mid-run janitor
    use_store: bool = False      # route payloads through (Faulty)Store
    fault_rules: tuple[FaultRule, ...] = ()
    fault_budget: int | None = None
    max_publish_attempts: int = 12
    publish_backoff_s: float = 0.001
    target: str = "main"


@dataclasses.dataclass
class AgentRecord:
    """What one agent attempted and how it ended."""

    agent: int
    idx: int
    run_id: str
    intent: str                       # behavior drawn for this run
    outcome: str = "pending"          # committed|aborted|abandoned|crashed
                                      # |released|skipped|branch_lost
    tables: dict[str, str] = dataclasses.field(default_factory=dict)
    branch: str | None = None
    final_commit: str | None = None
    verified_head: str | None = None
    released_head: str | None = None  # quarantine release: verified commit
    illegal_merge: bool = False       # unverified quarantine merge WORKED
    error: str = ""


@dataclasses.dataclass
class SwarmResult:
    config: SwarmConfig
    catalog: Catalog
    store: ObjectStore
    registry: RunRegistry
    plan: FaultPlan
    clock: FakeClock
    records: list[AgentRecord]
    gc_reports: list[GCReport]
    final_gc: GCReport | None = None

    @property
    def released_heads(self) -> tuple[str, ...]:
        """Commit ids re-verified by quarantine release — snapshots from
        aborted runs that these merges *legitimately* republished."""
        return tuple(r.released_head for r in self.records
                     if r.released_head is not None)

    def outcomes(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records:
            out[r.outcome] = out.get(r.outcome, 0) + 1
        return out


class _LiveSet:
    """Thread-safe run-liveness view; iterating snapshots atomically
    (``Catalog.gc`` does ``frozenset(live)`` under the catalog lock)."""

    def __init__(self):
        self._s: set[str] = set()
        self._lock = threading.Lock()

    def add(self, rid: str) -> None:
        with self._lock:
            self._s.add(rid)

    def discard(self, rid: str) -> None:
        with self._lock:
            self._s.discard(rid)

    def __iter__(self):
        with self._lock:
            return iter(list(self._s))


def _choose_intent(rng: random.Random, cfg: SwarmConfig,
                   pool_nonempty: bool) -> str:
    x = rng.random()
    for p, intent in ((cfg.p_violate, "violate"),
                      (cfg.p_abandon, "abandon"),
                      (cfg.p_reuse, "reuse"),
                      (cfg.p_contended, "contended"),
                      (cfg.p_multi, "multi")):
        if x < p:
            if intent == "reuse" and not pool_nonempty:
                return "disjoint"  # nothing aborted yet to reuse
            return intent
        x -= p
    return "disjoint"


def _table_set(intent: str, rng: random.Random, cfg: SwarmConfig,
               agent: int) -> list[str]:
    if intent == "contended":
        return [f"hot{rng.randrange(cfg.hot_tables)}"]
    if intent == "multi":
        names = [f"a{agent}_t{j}" for j in range(2 + rng.randrange(2))]
        if rng.random() < 0.5:   # multi-table runs may span a hot table
            names[0] = f"hot{rng.randrange(cfg.hot_tables)}"
        return names
    return [f"a{agent}"]         # disjoint / violate / abandon


def run_swarm(config: SwarmConfig, *,
              store: ObjectStore | None = None) -> SwarmResult:
    """Run the swarm to completion; returns everything the
    linearizability checker needs. The final-sweep GC (all agents
    joined, empty live set, zero grace) is always performed so the
    result's catalog reflects post-recovery steady state."""
    cfg = config
    inner = store if store is not None else MemoryStore()
    faulty = FaultyStore(inner)
    plan = FaultPlan(cfg.seed, cfg.fault_rules, budget=cfg.fault_budget)
    clock = FakeClock()
    catalog = Catalog(faulty)
    registry = RunRegistry()
    live = _LiveSet()
    records: list[AgentRecord] = []
    gc_reports: list[GCReport] = []
    aborted_pool: list[str] = []   # branch names available for reuse
    state_lock = threading.Lock()
    completions = [0]

    def one_run(agent: int, k: int) -> None:
        rng = random.Random(f"{cfg.seed}:agent{agent}:run{k}")
        with state_lock:
            pool_nonempty = bool(aborted_pool)
        intent = _choose_intent(rng, cfg, pool_nonempty)
        rid = f"sw{cfg.seed}-a{agent}r{k}"
        rec = AgentRecord(agent=agent, idx=k, run_id=rid, intent=intent)
        try:
            if intent == "reuse":
                _do_reuse(rec, rng, agent)
            else:
                _do_run(rec, rng, agent, k, intent)
        except InjectedCrash as e:
            rec.outcome = "crashed"
            rec.error = str(e)
        except TransactionAborted as e:
            rec.outcome = "aborted"
            rec.error = str(e)
            if rec.branch is not None:
                with state_lock:
                    aborted_pool.append(rec.branch)
        except BranchNotFound as e:
            # a normal run losing its branch mid-flight would mean GC
            # collected live state — the checker flags branch_lost;
            # reuse losing its *source* to GC is a benign race.
            rec.outcome = "skipped" if intent == "reuse" else "branch_lost"
            rec.error = str(e)
        except (VisibilityError, MergeConflict, RefConflict,
                CatalogError) as e:
            rec.outcome = "skipped"
            rec.error = str(e)
        finally:
            with state_lock:
                records.append(rec)
                completions[0] += 1
                n = completions[0]
            if cfg.gc_every and n % cfg.gc_every == 0:
                report = catalog.gc(live_runs=live,
                                    grace_s=cfg.gc_grace_s)
                with state_lock:
                    gc_reports.append(report)

    def _do_run(rec: AgentRecord, rng: random.Random, agent: int,
                k: int, intent: str) -> None:
        txn = TransactionalRun(
            catalog, cfg.target, run_id=rec.run_id, registry=registry,
            code=rec.run_id,
            max_publish_attempts=cfg.max_publish_attempts,
            publish_backoff_s=cfg.publish_backoff_s, clock=clock,
            backoff_seed=f"{cfg.seed}:{rec.run_id}")
        live.add(rec.run_id)    # heartbeat BEFORE the branch exists
        try:
            txn.begin()
            rec.branch = txn.branch
            tables: dict[str, str] = {}
            for i, t in enumerate(_table_set(intent, rng, cfg, agent)):
                payload = f"{t}@{rec.run_id}#{i}"   # unique per run
                try:
                    snap = (faulty.put(payload.encode())
                            if cfg.use_store else payload)
                except InjectedFault as e:
                    txn.abort(e)    # a failed physical write aborts cleanly
                    raise TransactionAborted(
                        f"store write failed: {e}", branch=txn.branch,
                        cause=e) from e
                tables[t] = snap
            rec.tables = dict(tables)
            txn.write_tables(tables, message=f"swarm {rec.run_id}")
            if intent == "violate":
                def bad(read):
                    raise ValueError("contract violation (injected)")
                txn.verify(bad)     # -> TransactionAborted
            expect = dict(tables)

            def check(read):
                for t, s in expect.items():
                    if read(t) != s:
                        raise ValueError(f"snapshot of {t!r} drifted")
            txn.verify(check)
            if intent == "abandon":
                rec.outcome = "abandoned"   # walk away: no commit/abort
                return
            merged = txn.commit()
            rec.outcome = "committed"
            rec.final_commit = merged.id
            rec.verified_head = registry.get_run(rec.run_id).verified_head
        finally:
            live.discard(rec.run_id)        # heartbeat stops, dead or done

    def _do_reuse(rec: AgentRecord, rng: random.Random,
                  agent: int) -> None:
        with state_lock:
            if not aborted_pool:
                rec.outcome = "skipped"
                rec.error = "no aborted branch to reuse"
                return
            src = aborted_pool[rng.randrange(len(aborted_pool))]
        qb = f"q/{rec.run_id}"
        catalog.create_branch(qb, src, allow_reuse=True)  # -> QUARANTINED
        rec.branch = qb
        t = f"requal_a{agent}"
        snap = f"{t}@{rec.run_id}#q"
        catalog.write_table(qb, t, snap)
        rec.tables = {t: snap}
        try:
            catalog.merge(qb, into=cfg.target,
                          message=f"illegal unverified merge {rec.run_id}")
            rec.illegal_merge = True    # Fig. 4 guardrail FAILED
            rec.outcome = "released"
            return
        except VisibilityError:
            pass                        # guardrail held, as it must

        def reverify(read):
            if read(t) != snap:
                raise ValueError("requalified snapshot drifted")
        head = catalog.release_quarantined(qb, reverify)
        rec.released_head = head.id
        merged = catalog.merge(qb, into=cfg.target,
                               message=f"release {rec.run_id}")
        rec.outcome = "released"
        rec.final_commit = merged.id

    def agent_main(agent: int) -> None:
        for k in range(cfg.runs_per_agent):
            one_run(agent, k)

    with fault_injection(plan):
        threads = [threading.Thread(target=agent_main, args=(a,),
                                    name=f"swarm-agent-{a}")
                   for a in range(cfg.n_agents)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        # recovery sweep: every agent is gone, so all remaining TXN and
        # ABORTED debris (crashes, abandons, un-reused aborts) goes.
        final_gc = catalog.gc(live_runs=(), grace_s=0.0)

    return SwarmResult(config=cfg, catalog=catalog, store=faulty,
                       registry=registry, plan=plan, clock=clock,
                       records=records, gc_reports=gc_reports,
                       final_gc=final_gc)
