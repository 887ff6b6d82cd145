"""The port's trace exporters (``repro_torch/obs/export.py``) against
``repro``'s (after ``tests/test_obs.py``'s exporter tests).

The same span dicts, and live spans recorded by each package's
``TraceRecorder`` over the same operations, must give byte-identical
``to_json`` strings, ``to_chrome_trace`` documents and
``write_chrome_trace`` files. Live spans carry wall-clock stamps, so
both packages' trace modules read one fake clock each, stepping alike.
"""
import itertools
import json

import pytest

import repro.obs as jobs
import repro.obs.trace as jtrace
import repro_torch.obs as tobs
import repro_torch.obs.trace as ttrace
from repro.core.catalog import Catalog as JCatalog
from repro.core.transactions import TransactionalRun as JRun
from repro_torch.core.catalog import Catalog as TCatalog
from repro_torch.core.transactions import TransactionalRun as TRun

SPAN_DICTS = [
    {"name": "run", "span_id": 1, "parent_id": None, "t0": 100.0,
     "t1": 100.25, "thread_id": 7, "attrs": {"run_id": "r0", "z": 1},
     "events": [{"name": "ref_conflict", "t": 100.1, "attempt": 1}]},
    {"name": "node.exec", "span_id": 2, "parent_id": 1, "t0": 100.05,
     "t1": None, "thread_id": 8, "attrs": {"rows": 5}, "events": []},
    {"name": "wave", "span_id": 3, "parent_id": 1, "t0": 99.5,
     "t1": 99.25, "thread_id": 7, "attrs": {}, "events": [
         {"name": "auto_decision", "t": 99.75, "choice": "torch"}]},
]


class _Clock:
    """A stand-in for the ``time`` module: each call steps 1 ms."""

    def __init__(self):
        self._t = itertools.count()

    def time(self) -> float:
        return 1000.0 + next(self._t) * 1e-3


@pytest.fixture
def clocks(monkeypatch):
    monkeypatch.setattr(jtrace, "time", _Clock())
    monkeypatch.setattr(ttrace, "time", _Clock())


def _same_exports(want_spans, got_spans, tmp_path):
    assert tobs.to_json(got_spans) == jobs.to_json(want_spans)
    assert tobs.to_json(got_spans, indent=None) == jobs.to_json(
        want_spans, indent=None)
    for pid in (1, 42):
        assert (json.dumps(tobs.to_chrome_trace(got_spans, pid=pid))
                == json.dumps(jobs.to_chrome_trace(want_spans, pid=pid)))
    tobs.write_chrome_trace(tmp_path / "port.json", got_spans)
    jobs.write_chrome_trace(tmp_path / "repro.json", want_spans)
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "repro.json").read_bytes())


def test_the_package_exports_what_repros_does():
    for name in ("to_json", "to_chrome_trace", "write_chrome_trace"):
        assert name in tobs.__all__ and callable(getattr(tobs, name))
    assert sorted(tobs.__all__) == sorted(jobs.__all__)


def test_span_dicts_export_byte_identical(tmp_path):
    _same_exports(SPAN_DICTS, SPAN_DICTS, tmp_path)
    doc = tobs.to_chrome_trace(SPAN_DICTS)
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts)
    # an open span (t1 None) and a clock that ran backwards give dur 0
    assert [e["dur"] for e in doc["traceEvents"] if e["ph"] == "X"
            and e["name"] in ("node.exec", "wave")] == [0.0, 0.0]


def _record(obs, Catalog, Run):
    with obs.tracing() as rec:
        with rec.span("outer", kind="test"):
            rec.event("mark", n=1)
            with rec.span("inner", rows=5) as sp:
                sp.set(cache="miss")
        cat = Catalog()
        txn = Run(cat, "main", run_id="r0")
        txn.begin()
        txn.write_tables({"a": "a@r0", "b": "b@r0"})
        txn.verify(lambda read: read("a"))
        cat.write_table("main", "other", "o1")    # forces one rebase
        txn.commit()
    return rec.spans()


def test_live_spans_export_byte_identical(clocks, tmp_path):
    want = _record(jobs, JCatalog, JRun)
    got = _record(tobs, TCatalog, TRun)
    assert [s.name for s in got] == [s.name for s in want]
    assert {"outer", "inner", "run", "rebase"} <= {s.name for s in got}
    _same_exports(want, got, tmp_path)
    # live spans and their dicts export alike
    assert tobs.to_json(got) == tobs.to_json([s.to_dict() for s in got])
