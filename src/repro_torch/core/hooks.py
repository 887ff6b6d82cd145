"""Named fault-injection points (the chaos tier's seam, DESIGN.md §15).

The chaos layer (:mod:`repro_torch.chaos`) needs to fail, delay, or crash the
system at *named* points — between the atomic metadata operations of the
publication loop, and around the physical store's ref writes — without
the core ever importing chaos code. This module is that seam: core call
sites invoke :func:`fault_point` with a dotted point name; in production
the hook is ``None`` and the whole call costs one global load and a
truth test (the same discipline as ``obs.get_recorder().enabled``).

The fault model this encodes (DESIGN.md §15): catalog metadata
operations are atomic (the paper's substrate guarantees them via a
relational database; here a lock), so faults are injected at the
*seams between* atomic ops — exactly where a real process dies — never
inside one. A hook may:

- return normally           (no fault);
- sleep / yield             (adversarial schedule perturbation);
- raise :class:`InjectedFault`  (an ``Exception``: the operation fails,
  normal error handling runs — the run aborts cleanly);
- raise :class:`InjectedCrash`  (a ``BaseException``: simulated process
  death — ``except Exception`` cleanup handlers must NOT run, just as
  they would not for a killed process).
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["InjectedFault", "InjectedCrash", "fault_point",
           "install_fault_hook"]


class InjectedFault(Exception):
    """A chaos-injected *recoverable* failure of one operation."""

    def __init__(self, point: str, detail: str = ""):
        super().__init__(f"injected fault at {point!r}"
                         + (f": {detail}" if detail else ""))
        self.point = point


class InjectedCrash(BaseException):
    """Simulated process death at a named point.

    Deliberately a ``BaseException``: the run's ``except Exception``
    cleanup (abort, branch marking) must not fire — a dead process
    cleans up nothing. Whatever state the crash leaves behind is what
    recovery (GC + the catalog's atomic refs) must cope with.
    """

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


FaultHook = Callable[[str, dict[str, Any]], None]

_hook: FaultHook | None = None


def fault_point(name: str, /, **ctx: Any) -> None:
    """Announce a named injection point. No-op unless a hook is
    installed; the hook decides (deterministically, from its seed)
    whether to fault, delay, or crash here."""
    hook = _hook
    if hook is not None:
        hook(name, ctx)


def install_fault_hook(hook: FaultHook | None) -> FaultHook | None:
    """Install (or clear, with ``None``) the process-wide hook;
    returns the previous one so scopes can nest."""
    global _hook
    prev = _hook
    _hook = hook
    return prev
