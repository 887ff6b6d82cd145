"""Counters/histograms registry: the aggregate view of trace events.

Spans answer "what happened in *this* run"; the registry answers "how
often / how long across everything the recorder saw" — cache hit rate,
nodes re-executed per rebase, per-kernel wall time — without walking
span trees. The same instrumentation sites feed both (one event, one
``inc``/``observe``), and :meth:`MetricsRegistry.snapshot` serializes
into run manifests and BENCH documents.

A :class:`Histogram` keeps O(1) state (count/sum/min/max), not samples:
manifests must stay small no matter how many nodes a run executes.

A :class:`Tally` counts on the card: a 0-d int64 tensor on the device
of what it is handed, added to in place, so counting what a kernel
decided (the MoE's kept pairs) costs no sync. :meth:`MetricsRegistry.
snapshot` reads each tally once, among the counters.

``NULL_METRICS`` is the disabled path — a registry whose instruments
drop every update with no allocation, shared by every NullRecorder.
"""
from __future__ import annotations

import threading
from typing import Any

import torch

__all__ = ["Counter", "Histogram", "Tally", "MetricsRegistry",
           "NULL_METRICS"]


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Tally:
    """A count kept on the card: ``add(x)`` adds an integer tensor ``x``
    (0-d) in place, with no sync; ``value`` is the tensor, or None
    before the first ``add``."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def add(self, x) -> None:
        with self._lock:
            if self.value is None:
                self.value = x.new_zeros((), dtype=torch.int64)
            self.value.add_(x)


class Histogram:
    """O(1) summary of observations (count/sum/min/max; mean derived)."""

    __slots__ = ("_lock", "count", "sum", "min", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max, "mean": self.mean}


class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullTally:
    __slots__ = ()
    value = None

    def add(self, x) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count, sum, min, max, mean = 0, 0.0, None, None, 0.0

    def observe(self, v: float) -> None:
        pass

    def to_dict(self) -> dict[str, Any]:   # pragma: no cover - not hit
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "mean": 0.0}


_NULL_COUNTER = _NullCounter()
_NULL_HISTOGRAM = _NullHistogram()
_NULL_TALLY = _NullTally()


class MetricsRegistry:
    """Name -> instrument, created on first use; thread-safe."""

    def __init__(self, *, null: bool = False):
        self._null = null
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._histograms: dict[str, Histogram] = {}
        self._tallies: dict[str, Tally] = {}

    def counter(self, name: str) -> Counter:
        if self._null:
            return _NULL_COUNTER          # type: ignore[return-value]
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def histogram(self, name: str) -> Histogram:
        if self._null:
            return _NULL_HISTOGRAM        # type: ignore[return-value]
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def tally(self, name: str) -> Tally:
        if self._null:
            return _NULL_TALLY            # type: ignore[return-value]
        with self._lock:
            t = self._tallies.get(name)
            if t is None:
                t = self._tallies[name] = Tally()
            return t

    def snapshot(self) -> dict[str, Any]:
        """JSON-serializable state: {"counters": {...}, "histograms":
        {...}} plus derived rates the manifests/benchmarks read. The
        tallies are among the counters, each read from the card here
        (one sync)."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            tallies = {n: t.value for n, t in self._tallies.items()
                       if t.value is not None}
            hists = {n: h.to_dict() for n, h in self._histograms.items()}
        counters.update((n, int(v)) for n, v in tallies.items())
        out: dict[str, Any] = {"counters": counters, "histograms": hists}
        hits = counters.get("engine.cache.hits", 0)
        misses = counters.get("engine.cache.misses", 0)
        if hits + misses:
            out["derived"] = {
                "cache_hit_rate": hits / (hits + misses)}
        return out


NULL_METRICS = MetricsRegistry(null=True)
