"""Wave-parallel, content-addressed incremental execution engine.

DESIGN.md §8. Two orthogonal accelerations over the sequential
node-at-a-time worker the paper describes:

- **Wave scheduling**: :func:`repro_torch.core.planner.plan` assigns every
  step a dependency level (*wave*); :class:`PlanExecutor` runs each
  wave's nodes concurrently on a thread pool. A wave only starts after
  the previous wave fully drained, so every node sees exactly the
  snapshots its inputs published — the §3.3 read-isolation story is
  unchanged, just wider.

- **Content-addressed function cache** (:class:`NodeCache`): each node
  evaluation is keyed by ``hash(node source + output-schema fingerprint
  + declared casts, input snapshot keys)``. On a hit the engine skips
  execution and reuses the stored output snapshot — but still runs
  :func:`validate_table` against the declared contract (minus the
  checks Appendix A statically discharged), so a cache hit can never
  launder data past the worker moment. Entries persist as named refs in
  the :class:`~repro_torch.core.store.ObjectStore`, so a file-backed cache
  survives restarts and is shared by every client of the store.

Failure semantics (the abort path of §3.3): when a node fails, its
in-flight wave siblings are *drained, not cancelled*; every output that
passed validation — earlier waves plus validated siblings, in plan
order — is reported via :class:`~repro_torch.core.errors.ExecutionError`
``.partial`` so the runner can flush exactly the validated outputs to
the ABORTED branch, deterministically.
"""
from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping

from repro_torch import exec as exec_backends
from repro_torch.core.contracts import validate_table
from repro_torch.core.errors import ExecutionError
from repro_torch.core.planner import Plan, PlanStep
from repro_torch.core.store import ObjectStore
from repro_torch.data.tables import Table
from repro_torch.obs import get_recorder

__all__ = ["cache_key", "NodeCache", "ExecutionOutcome", "PlanExecutor"]


def cache_key(step: PlanStep,
              input_snapshots: Mapping[str, str]) -> str | None:
    """Content address of one node evaluation.

    Static half: the node's transformation source, output-schema
    fingerprint, and declared casts (``Node.cache_material``). Dynamic
    half: the snapshot key of every input, keyed by *parameter* name —
    not merely the sorted key set, because a binary node applied to
    ``(A, B)`` and ``(B, A)`` is a different evaluation — plus the
    *cache token* of the active execution backend (DESIGN.md §9/§10):
    all backends are *supposed* to agree bit-for-bit, but a cache hit
    must never be the mechanism that launders a divergent backend's
    output past that claim, so switching backends moves every key. The
    token extends the bare name with ambient execution state the
    backend depends on — the device of the ``torch`` backend — because
    another device regroups float SUM summation order under the
    documented carve-out and must never serve a stale cross-device hit. ``None`` if the node
    is not content-addressable (e.g. it captures state that cannot be
    fingerprinted stably): such nodes always execute.

    Optimizer state is key material too, same discipline: the active
    pass list and the step's rewrite provenance are folded in, so
    flipping a pass (or a pass rewriting a tree differently) can never
    serve a stale cross-plan hit. An unoptimized plan (empty pass
    list) keys exactly as before. The rewritten logical tree itself is
    already the static half (``PlanStep.cache_material`` describes the
    tree the step will actually execute, not the authored node body).

    Non-key material, by invariant (DESIGN.md §14, test-gated): nothing
    from ``repro_torch.obs`` — tracing on or off, and any trace contents,
    share cache entries bit for bit.
    """
    material = step.cache_material()
    if material is None:
        return None
    h = hashlib.sha256()
    h.update(material.encode())
    h.update(
        f"|backend={exec_backends.active_backend().cache_token()}".encode())
    if step.opt_passes:
        h.update(f"|opt={','.join(step.opt_passes)}".encode())
    for p in step.provenance:
        h.update(f"|rw={p}".encode())
    for param in sorted(input_snapshots):
        h.update(f"|{param}={input_snapshots[param]}".encode())
    return h.hexdigest()[:32]


class NodeCache:
    """``cache_key -> output snapshot key``, persisted as store refs.

    The cache records *function evaluations*, not publications: an entry
    written by a run that later aborts (verifier failure, publication
    conflict) is still sound — the snapshot it names was produced by
    exactly this function over exactly these inputs and passed worker
    validation. Transactional guarantees stay with the run protocol;
    the cache only ever short-circuits recomputation.

    Correctness assumes node functions are deterministic. A
    nondeterministic node degrades to pinning its first observed output
    (reproducible-by-construction, the function-caching stance of
    "Reproducible data science over data lakes").
    """

    REF_PREFIX = "fncache/"

    def __init__(self, store: ObjectStore):
        self.store = store
        self._mem: dict[str, str] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, key: str) -> str | None:
        with self._lock:
            snap = self._mem.get(key)
        if snap is None:
            snap = self.store.get_ref(self.REF_PREFIX + key)
        # the ref is only as good as the blob it points to: a pruned
        # store demotes the entry to a miss instead of a KeyError.
        if snap is not None and snap in self.store:
            with self._lock:
                self._mem[key] = snap
                self.hits += 1
            return snap
        with self._lock:
            self.misses += 1
        return None

    def put(self, key: str, snapshot: str) -> None:
        with self._lock:
            self._mem[key] = snapshot
        self.store.put_ref(self.REF_PREFIX + key, snapshot)


@dataclasses.dataclass(frozen=True)
class ExecutionOutcome:
    """Result of one full plan execution (all waves drained)."""

    snapshots: Mapping[str, str]   # table -> output snapshot key
    executed: tuple[str, ...]      # nodes actually run (cache misses)
    cached: tuple[str, ...]        # nodes satisfied from the cache


class PlanExecutor:
    """Executes a validated :class:`Plan` wave by wave.

    Stateless across :meth:`execute` calls except for the (shared,
    thread-safe) :class:`NodeCache`, so one executor instance serves
    both the initial run and post-rebase re-execution.
    """

    def __init__(self, plan: Plan, store: ObjectStore, *,
                 cache: NodeCache | None = None,
                 max_workers: int | None = None):
        self.plan = plan
        self.store = store
        self.cache = cache
        widest = max((len(w) for w in plan.waves), default=1)
        self.max_workers = max(1, max_workers if max_workers is not None
                               else min(16, widest))

    # ------------------------------------------------------------------
    def execute(self, resolve_source: Callable[[str], str], *,
                fail_after: str | None = None) -> ExecutionOutcome:
        """Run every wave; returns the full table -> snapshot mapping.

        ``resolve_source`` maps a *source* table name to its snapshot
        key (the runner binds it to the transactional branch, so reads
        are pinned). ``fail_after`` injects a failure after the named
        node validates — the deterministic abort-path hook.
        """
        snaps: dict[str, str] = {}      # table -> snapshot (sources too)
        tables: dict[str, Table] = {}   # materialized tables
        mat_lock = threading.Lock()     # guards lazy source loads
        # validated PUBLISHED outputs, plan order — optimizer-
        # materialized auxiliary steps execute and cache like any node
        # but never reach the commit/flush set.
        written: dict[str, str] = {}
        executed: list[str] = []
        cached: list[str] = []

        def materialize(table: str) -> Table:
            # upstream outputs were installed between waves; only source
            # tables are lazily loaded (and memoized) here.
            if table in tables:
                return tables[table]
            with mat_lock:
                if table not in tables:
                    tables[table] = Table.from_blobs(self.store,
                                                     snaps[table])
                return tables[table]

        rec = get_recorder()
        # Per-node runtime profile, collected unconditionally (a few
        # dict writes per NODE, not per row) so `plan.describe(
        # analyze=True)` works with tracing off. Name -> record.
        profile: dict[str, dict] = {}

        def run_step(step: PlanStep):
            """Returns (snapshot|None, table|None, was_cached, error)."""
            if rec.enabled:
                with rec.span("node", node=step.node.name,
                              wave=step.wave) as sp:
                    return step_body(step, sp)
            return step_body(step, None)

        def step_body(step: PlanStep, sp):
            node = step.node
            t_start = time.perf_counter()
            verdict = "uncacheable"
            key = None
            out = None
            try:
                in_snaps = {}
                for param, t in node.inputs.items():
                    if t not in snaps:
                        with mat_lock:
                            if t not in snaps:
                                snaps[t] = resolve_source(t)
                    in_snaps[param] = snaps[t]
                key = (cache_key(step, in_snaps)
                       if self.cache is not None else None)
                if key is not None:
                    verdict = "miss"
                    hit = self.cache.lookup(key)
                    if hit is not None:
                        try:
                            out = Table.from_blobs(self.store, hit)
                        except KeyError:
                            # manifest survived but a column blob was
                            # pruned: demote to a miss and recompute
                            # (never abort on a stale cache entry).
                            out = None
                        if out is not None:
                            # a hit is still physically validated
                            # against the CURRENT plan's contract; only
                            # the checks Appendix A discharged are
                            # skipped.
                            validate_table(out, node.output_schema,
                                           elide=step.elided_null_checks,
                                           name=node.name)
                            verdict = "hit"
                            return hit, out, True, self._inject(
                                step, fail_after)
                ins = {t: materialize(t)
                       for t in set(node.inputs.values())}
                out = step.execute(ins)
                # moment (3): validate physical data BEFORE persisting.
                validate_table(out, node.output_schema,
                               elide=step.elided_null_checks,
                               name=node.name)
                snap = out.to_blobs(self.store)
                if key is not None:
                    self.cache.put(key, snap)
                return snap, out, False, self._inject(step, fail_after)
            except Exception as e:
                verdict = "error"
                return None, None, False, e
            finally:
                wall_s = time.perf_counter() - t_start
                rows_out = out.num_rows if out is not None else None
                record = {"node": node.name, "wave": step.wave,
                          "cache": verdict, "wall_s": wall_s,
                          "rows_out": rows_out}
                with mat_lock:
                    profile[node.name] = record
                if sp is not None:
                    sp.set(cache=verdict, rows_out=rows_out)
                    if key is not None:
                        sp.set(cache_key=key)
                    m = rec.metrics
                    if verdict == "hit":
                        m.counter("engine.cache.hits").inc()
                    elif verdict == "miss":
                        m.counter("engine.cache.misses").inc()
                    m.histogram("engine.node.wall_s").observe(wall_s)

        def submit(pool, step):
            # copy_context(): worker threads inherit the submitting
            # wave span as ambient parent (a fresh Context per task —
            # one Context cannot be entered by two threads at once).
            if rec.enabled:
                return pool.submit(contextvars.copy_context().run,
                                   run_step, step)
            return pool.submit(run_step, step)

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            for wave_idx, wave in enumerate(self.plan.waves):
                wave_span = (rec.span("wave", index=wave_idx,
                                      nodes=len(wave))
                             if rec.enabled else None)
                if wave_span is not None:
                    wave_span.__enter__()
                try:
                    futures = [submit(pool, step) for step in wave]
                    errors: list[tuple[str, BaseException]] = []
                    # drain the WHOLE wave before acting on any
                    # failure: siblings in flight finish, and their
                    # validated outputs are preserved — the flush set
                    # is a deterministic function of the plan, not of
                    # thread timing.
                    for step, fut in zip(wave, futures):
                        snap, table, was_cached, err = fut.result()
                        name = step.node.name
                        if snap is not None:
                            if step.published:
                                written[name] = snap
                            snaps[name] = snap
                            tables[name] = table
                            (cached if was_cached
                             else executed).append(name)
                        if err is not None:
                            errors.append((name, err))
                finally:
                    if wave_span is not None:
                        wave_span.__exit__(None, None, None)
                if errors:
                    name, cause = errors[0]   # first in plan order
                    self._attach_runtime(profile)
                    raise ExecutionError(
                        f"node {name!r} failed: {cause}", cause=cause,
                        partial=written, executed=tuple(executed),
                        cached=tuple(cached))
        self._attach_runtime(profile)
        return ExecutionOutcome(snapshots=dict(written),
                                executed=tuple(executed),
                                cached=tuple(cached))

    def _attach_runtime(self, profile: dict[str, dict]) -> None:
        # Plan is a frozen dataclass; the profile rides as a non-field
        # attribute (observational only — never part of plan identity
        # or cache keys). `describe(analyze=True)` renders it.
        object.__setattr__(self.plan, "_runtime", profile)

    @staticmethod
    def _inject(step: PlanStep, fail_after: str | None):
        if fail_after == step.node.name:
            # testing hook: the node's own output validated (and is
            # preserved); the failure hits while wave siblings may
            # still be in flight.
            return RuntimeError(
                f"injected failure after node {step.node.name!r}")
        return None
