"""Deterministic seeded fault injection (DESIGN.md §15).

A :class:`FaultPlan` is the single decision engine: given a seed and a
set of :class:`FaultRule`\\ s, it decides — *deterministically from the
seed* — what happens each time execution passes a named
:func:`~repro_torch.core.hooks.fault_point`. The n-th visit to point ``p``
under seed ``s`` always gets the same decision, because the decision
RNG is keyed ``f"{s}:{p}:{n}"`` with a per-point visit counter; thread
interleaving changes *which thread* draws visit ``n``, never what
visit ``n`` does. Replaying a failing seed therefore replays the same
fault budget at the same points.

Rules match points by dotted-name prefix, so ``FaultRule("txn.commit",
"fail", 0.2)`` covers every seam in the publication loop while
``FaultRule("filestore.put_ref.pre_replace", "crash", 1.0)`` targets
exactly the ref torn-write window. Kinds:

- ``"fail"``  → raise :class:`~repro_torch.core.hooks.InjectedFault`
  (recoverable: the op errors, normal abort paths run);
- ``"crash"`` → raise :class:`~repro_torch.core.hooks.InjectedCrash`
  (simulated process death: ``except Exception`` cleanup is skipped);
- ``"torn"``  → like ``"crash"``, but first truncate the in-flight
  temp file (``ctx["tmp"]``) to a seeded byte length — the
  torn-write adversary for :meth:`FileStore.put_ref`;
- ``"delay"`` → sleep a seeded ``U[0, delay_s]`` (real wall time by
  default: delays exist to perturb thread schedules).

``budget`` caps the total number of fail/crash/torn injections — the
fixed fault budget the contended-publication benchmark's success-rate
gate runs under. Delays don't consume budget.

:class:`FaultyStore` wraps any :class:`~repro_torch.core.store.ObjectStore`
and announces a fault point before each operation, putting the
physical layer under the same plan as the publication loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time
from typing import Any, Callable, Iterator, Sequence

from repro_torch.core.hooks import (InjectedCrash, InjectedFault, fault_point,
                                    install_fault_hook)
from repro_torch.core.store import ObjectStore
from repro_torch.obs import get_recorder

__all__ = ["FaultRule", "FaultPlan", "FaultyStore", "fault_injection"]

_FAULT_KINDS = ("fail", "crash", "torn", "delay")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule: at points matching ``match`` (dotted-name
    prefix), act with probability ``rate`` per visit."""

    match: str
    kind: str              # "fail" | "crash" | "torn" | "delay"
    rate: float = 1.0
    delay_s: float = 0.002  # max sleep for kind="delay"

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_FAULT_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


class FaultPlan:
    """Seed-deterministic fault decisions over named points.

    Thread-safe; one plan is shared by every thread of a swarm. The
    ``injected`` log records ``(point, visit_n, kind)`` for every
    injection actually fired — the replay/debug trail a failing seed
    ships with.
    """

    def __init__(self, seed: int | str, rules: Sequence[FaultRule] = (),
                 *, budget: int | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.seed = seed
        self.rules = tuple(rules)
        self.budget = budget
        self._sleep = sleep
        self._lock = threading.Lock()
        self._visits: dict[str, int] = {}
        self._spent = 0
        self.injected: list[tuple[str, int, str]] = []

    @property
    def faults_injected(self) -> int:
        with self._lock:
            return self._spent

    def _decide(self, point: str) -> tuple[FaultRule | None, int,
                                           random.Random]:
        """Pick the rule (if any) firing at this visit. The visit
        counter is the only shared state consulted, so the mapping
        visit-number → decision is pure in (seed, point, n)."""
        with self._lock:
            n = self._visits.get(point, 0)
            self._visits[point] = n + 1
        rng = random.Random(f"{self.seed}:{point}:{n}")
        for rule in self.rules:
            if point.startswith(rule.match) and rng.random() < rule.rate:
                return rule, n, rng
        return None, n, rng

    def __call__(self, point: str, ctx: dict[str, Any]) -> None:
        """The installed hook: act on ``fault_point(point, **ctx)``."""
        rule, n, rng = self._decide(point)
        if rule is None:
            return
        if rule.kind == "delay":
            self._record(point, n, "delay")
            self._sleep(rng.uniform(0.0, rule.delay_s))
            return
        # fail/crash/torn consume the fault budget atomically.
        with self._lock:
            if self.budget is not None and self._spent >= self.budget:
                return
            self._spent += 1
        self._record(point, n, rule.kind)
        if rule.kind == "fail":
            raise InjectedFault(point)
        if rule.kind == "torn":
            tmp = ctx.get("tmp")
            if tmp is not None and os.path.exists(tmp):
                size = os.path.getsize(tmp)
                with open(tmp, "r+b") as f:
                    f.truncate(rng.randrange(size) if size else 0)
        raise InjectedCrash(point)

    def _record(self, point: str, n: int, kind: str) -> None:
        with self._lock:
            self.injected.append((point, n, kind))
        rec = get_recorder()
        if rec.enabled:
            rec.event("injected_fault", point=point, visit=n, kind=kind)
            rec.metrics.counter(f"chaos.injected.{kind}").inc()


@contextlib.contextmanager
def fault_injection(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Scope within which ``plan`` drives every ``fault_point``.

    Restores the previously installed hook on exit, so chaos scopes
    nest and tests cannot leak a hook into each other.
    """
    prev = install_fault_hook(plan)
    try:
        yield plan
    finally:
        install_fault_hook(prev)


class FaultyStore(ObjectStore):
    """Wrap a store so every operation passes a ``store.*`` fault point.

    The wrapper holds no policy: with no hook installed it is a pure
    passthrough, and under :func:`fault_injection` the plan decides.
    Structured helpers (``put_json``/``put_array``/pytrees) inherit the
    faults because they bottom out in :meth:`put`/:meth:`get`.
    """

    def __init__(self, inner: ObjectStore):
        self.inner = inner

    def put(self, data: bytes) -> str:
        fault_point("store.put", n_bytes=len(data))
        return self.inner.put(data)

    def get(self, key: str) -> bytes:
        fault_point("store.get", key=key)
        return self.inner.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self.inner

    def keys(self) -> Iterator[str]:
        return self.inner.keys()

    def put_ref(self, name: str, key: str) -> None:
        fault_point("store.put_ref", name=name, key=key)
        self.inner.put_ref(name, key)

    def get_ref(self, name: str) -> str | None:
        fault_point("store.get_ref", name=name)
        return self.inner.get_ref(name)

    def refs(self, prefix: str = "") -> Iterator[str]:
        return self.inner.refs(prefix)

    def delete_ref(self, name: str) -> bool:
        fault_point("store.delete_ref", name=name)
        return self.inner.delete_ref(name)

    def __getattr__(self, name: str) -> Any:
        # sweep_tmp and any backend-specific surface delegate; hasattr
        # answers match the wrapped backend's.
        return getattr(self.inner, name)
