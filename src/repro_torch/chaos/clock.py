"""Injectable clocks: chaos schedules must run deterministically fast.

:class:`TransactionalRun` takes ``clock=`` (anything with ``sleep``).
The default is the wall clock; under chaos a shared :class:`FakeClock`
absorbs every backoff sleep into virtual time, so a 256-agent swarm
with thousands of publication retries finishes in milliseconds while
the *schedule* of retries (which attempt slept how long, from the
seeded jitter) is fully preserved and replayable.
"""
from __future__ import annotations

import threading
import time

__all__ = ["FakeClock"]


class FakeClock:
    """Virtual time: ``sleep`` advances a counter instead of blocking.

    Each sleep still yields the GIL once (``time.sleep(0)``) so the
    call remains a real thread-scheduling point — backoff keeps its
    role as a schedule perturbation, it just stops costing wall time.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.now_s = 0.0            # total virtual time slept
        self.sleep_count = 0

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self.now_s += seconds
            self.sleep_count += 1
        time.sleep(0)   # preserve the scheduling point, not the wait

    def time(self) -> float:
        with self._lock:
            return self.now_s
