"""Hierarchical structured tracing: the flight recorder (DESIGN.md §14).

A *span* is one timed region of a run — ``run`` → ``publication
attempt`` → ``rebase``/``revalidate`` → ``plan wave`` → ``node
execution`` → ``backend kernel call`` on the transactional path,
``sql`` → ``parse`` → ``compile`` → ``infer`` on the query path —
carrying typed attributes (rows in/out, cache verdict + key, the
``auto`` backend's decision and *why*, optimizer pass provenance,
bytes moved by the sharded exchange, rebase conflict details). Spans
form a tree via parent ids; *events* are point-in-time records attached
to the innermost open span (degradations, backend decisions, conflict
details).

Two recorders implement one protocol:

- :class:`NullRecorder` — the default. ``enabled`` is False, ``span()``
  returns a shared no-op context manager, ``event()`` returns
  immediately, and the metrics registry drops everything. Call sites
  follow the discipline *no string formatting and no dict building
  unless* ``rec.enabled`` *(or the values are already at hand)*, so the
  disabled path costs two attribute loads and a truth test per op —
  gated ≤2% by ``benchmarks/tracing_overhead.py``.
- :class:`TraceRecorder` — appends finished spans to a thread-safe
  list. Span parentage propagates through a :mod:`contextvars`
  variable, so nesting is correct across the engine's wave thread pool
  (the executor copies the submitting context per task) and across
  concurrent transactional runs in different threads (a fresh thread
  starts with an empty context, so runs never adopt each other's
  spans).

**The cache-key non-interference invariant** (test-gated): nothing in
this module is ever consulted by ``repro_torch.core.engine.cache_key`` or by
any backend ``cache_token`` — tracing on/off, or two different
recorders, share cache entries bit for bit. Tracing observes execution;
it must never *be* execution state.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Any

from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry

__all__ = ["Span", "Recorder", "NullRecorder", "TraceRecorder",
           "get_recorder", "install", "tracing"]


class Span:
    """One timed region. Mutable while open (attributes are set as the
    instrumented code learns them); treated as immutable once ``t1``
    is stamped. ``attrs`` values must be JSON-serializable."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs",
                 "events", "thread_id")

    def __init__(self, name: str, span_id: int, parent_id: int | None,
                 attrs: dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.time()
        self.t1: float | None = None
        self.attrs = attrs
        self.events: list[dict[str, Any]] = []
        self.thread_id = threading.get_ident()

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else time.time()) - self.t0

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "t0": self.t0,
                "t1": self.t1, "thread_id": self.thread_id,
                "attrs": dict(self.attrs), "events": list(self.events)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<Span {self.name!r} id={self.span_id} "
                f"parent={self.parent_id} attrs={self.attrs}>")


class _NullSpan:
    """Shared no-op span/context-manager: the whole disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Recorder:
    """The tracing protocol. ``enabled`` gates every call site."""

    enabled: bool = False
    metrics: MetricsRegistry = NULL_METRICS

    def span(self, name: str, /, **attrs: Any):
        """Context manager for one span; yields the span so the body
        can ``.set(...)`` attributes discovered during execution."""
        raise NotImplementedError

    def start_span(self, name: str, /, **attrs: Any):
        """Non-context-managed open (for begin()/commit() pairs split
        across calls); close with :meth:`end_span`."""
        raise NotImplementedError

    def end_span(self, span) -> None:
        raise NotImplementedError

    def event(self, name: str, /, **attrs: Any) -> None:
        """Attach a point-in-time event to the innermost open span."""
        raise NotImplementedError


class NullRecorder(Recorder):
    enabled = False
    metrics = NULL_METRICS

    def span(self, name: str, /, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def start_span(self, name: str, /, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def end_span(self, span) -> None:
        pass

    def event(self, name: str, /, **attrs: Any) -> None:
        pass


# The ambient parent span. Worker threads start with an empty context
# (parent=None) unless the submitter copies its context in — which is
# exactly what the engine does per task, so node spans nest under the
# wave/run that scheduled them while unrelated threads stay separate.
_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "repro_obs_current_span", default=None)


class _SpanCtx:
    """Context manager pairing one Span with the ambient-parent var."""

    __slots__ = ("recorder", "span", "_token")

    def __init__(self, recorder: "TraceRecorder", span: Span):
        self.recorder = recorder
        self.span = span
        self._token: contextvars.Token | None = None

    def __enter__(self) -> Span:
        self._token = _current.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.span.attrs.setdefault("error", repr(exc))
        _current.reset(self._token)
        self.recorder._finish(self.span)
        return False


class TraceRecorder(Recorder):
    """Collects spans and events; one instance per trace sink.

    Thread-safe: span creation/finish and event attachment lock a
    single mutex; span *attribute* writes are single-writer by
    construction (only the code inside the span's scope sets them).
    """

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: list[Span] = []        # finished, finish order
        self._open: dict[int, Span] = {}    # still running
        self._orphan_events: list[dict[str, Any]] = []  # no open span
        self.metrics = MetricsRegistry()

    # -- span lifecycle -------------------------------------------------
    def _new_span(self, name: str, attrs: dict[str, Any],
                  parent: "Span | None") -> Span:
        with self._lock:
            sid = next(self._ids)
            sp = Span(name, sid, parent.span_id if parent else None,
                      attrs)
            self._open[sid] = sp
        return sp

    def _finish(self, span: Span) -> None:
        span.t1 = time.time()
        with self._lock:
            self._open.pop(span.span_id, None)
            self._spans.append(span)

    def span(self, name: str, /, **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, self._new_span(name, attrs,
                                             _current.get()))

    def start_span(self, name: str, /, **attrs: Any) -> Span:
        sp = self._new_span(name, attrs, _current.get())
        # begin()/commit() run in the opening thread: make the open
        # span the ambient parent there (threads the run span under
        # nothing but over everything the run does in this thread).
        _current.set(sp)
        return sp

    def end_span(self, span: Span) -> None:
        if isinstance(span, _NullSpan) or span.t1 is not None:
            return
        if _current.get() is span:
            _current.set(self._parent_of(span))
        self._finish(span)

    def _parent_of(self, span: Span) -> "Span | None":
        if span.parent_id is None:
            return None
        with self._lock:
            if span.parent_id in self._open:
                return self._open[span.parent_id]
            for s in self._spans:
                if s.span_id == span.parent_id:
                    return s
        return None

    # -- events ---------------------------------------------------------
    def event(self, name: str, /, **attrs: Any) -> None:
        cur = _current.get()
        ev = {"name": name, "t": time.time(), **attrs}
        if cur is not None:
            with self._lock:
                cur.events.append(ev)
        else:
            with self._lock:
                self._orphan_events.append(ev)

    def orphan_events(self) -> list[dict[str, Any]]:
        """Events recorded with no open span (top-level context)."""
        with self._lock:
            return list(self._orphan_events)

    # -- introspection ---------------------------------------------------
    def spans(self, name: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def find(self, name: str) -> "Span | None":
        for s in self.spans(name):
            return s
        return None

    def subtree(self, root: Span) -> list[Span]:
        """All finished spans under ``root`` (inclusive), in start
        order — the serialization unit of a run manifest."""
        with self._lock:
            spans = list(self._spans)
        children: dict[int | None, list[Span]] = {}
        for s in spans:
            children.setdefault(s.parent_id, []).append(s)
        out: list[Span] = []
        stack = [root]
        while stack:
            s = stack.pop()
            out.append(s)
            stack.extend(children.get(s.span_id, ()))
        out.sort(key=lambda s: (s.t0, s.span_id))
        return out


# ---------------------------------------------------------------------------
# the ambient recorder
# ---------------------------------------------------------------------------

_recorder: Recorder = NullRecorder()
_install_lock = threading.Lock()


def get_recorder() -> Recorder:
    """The process-ambient recorder (a NullRecorder unless tracing is
    on). Instrumentation sites call this once per operation — never per
    row — and gate any work beyond the no-op calls on ``.enabled``."""
    return _recorder


def install(recorder: Recorder) -> Recorder:
    """Install ``recorder`` process-wide; returns the previous one."""
    global _recorder
    with _install_lock:
        prev = _recorder
        _recorder = recorder
    return prev


class tracing:
    """``with tracing() as rec:`` — install a fresh TraceRecorder for
    the block, restore the previous recorder after. Also usable as
    ``tracing(rec)`` to install a caller-built recorder."""

    def __init__(self, recorder: "TraceRecorder | None" = None):
        self.recorder = recorder if recorder is not None \
            else TraceRecorder()
        self._prev: Recorder | None = None

    def __enter__(self) -> TraceRecorder:
        self._prev = install(self.recorder)
        return self.recorder

    def __exit__(self, *exc) -> bool:
        install(self._prev)
        return False
