"""Trace exporters: plain JSON and Chrome trace-event format.

The Chrome format (one ``{"traceEvents": [...]}`` document of complete
``"ph": "X"`` events with microsecond timestamps) loads directly into
``chrome://tracing`` / Perfetto, which is the cheapest possible
flame-graph UI for a run: each span becomes a slice on its thread's
track, attributes ride in ``args``, and point events become ``"ph":
"i"`` instants. Works from either live :class:`~repro_torch.obs.trace.Span`
objects or the span dicts stored in a run manifest.
"""
from __future__ import annotations

import json
from typing import Any

__all__ = ["spans_to_dicts", "to_json", "to_chrome_trace",
           "write_chrome_trace"]


def spans_to_dicts(spans) -> list[dict[str, Any]]:
    """Normalize live Spans or already-serialized dicts to dicts."""
    return [s if isinstance(s, dict) else s.to_dict() for s in spans]


def to_json(spans, *, indent: int | None = 2) -> str:
    return json.dumps({"spans": spans_to_dicts(spans)}, indent=indent,
                      sort_keys=True)


def _category(name: str) -> str:
    # First path segment groups related spans onto one color in the UI.
    return name.split(".", 1)[0]


def to_chrome_trace(spans, *, pid: int = 1) -> dict[str, Any]:
    """Chrome trace-event document for ``spans`` (Spans or dicts)."""
    events: list[dict[str, Any]] = []
    for s in spans_to_dicts(spans):
        t0 = s["t0"]
        t1 = s["t1"] if s["t1"] is not None else t0
        ts_us = t0 * 1e6
        events.append({
            "name": s["name"],
            "cat": _category(s["name"]),
            "ph": "X",
            "ts": ts_us,
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": pid,
            "tid": s["thread_id"],
            "args": dict(s["attrs"]),
        })
        for ev in s["events"]:
            ev = dict(ev)
            events.append({
                "name": ev.pop("name"),
                "cat": "event",
                "ph": "i",
                "ts": ev.pop("t") * 1e6,
                "pid": pid,
                "tid": s["thread_id"],
                "s": "t",
                "args": ev,
            })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, spans, *, pid: int = 1) -> None:
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(spans, pid=pid), fh)
