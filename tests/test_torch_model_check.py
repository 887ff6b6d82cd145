"""The port's executable Alloy model (``repro_torch/core/model_check.py``)
against ``repro``'s (after ``tests/test_model_check.py``).

The same operation sequences drive both packages' ``LakehouseModel``:
fixed ones (the paper's Fig. 3 and Fig. 4 traces, the stale-publication
counterexample, the GC cases) and ones drawn by hypothesis, with a
fixed ``max_examples`` and ``derandomize=True``. After every step the
two models must agree exactly on ``torn_runs``, ``is_consistent``,
``stale_publications`` and ``collected_live_branches`` (and on the
error an operation raised, by class name). The unguarded and stale
variants reach a bad state, on their counterexamples and in the drawn
search; the guarded rebase variant never reaches one.
"""
import pytest

pytest.importorskip(
    "hypothesis",
    reason="property search needs hypothesis (pip install -r "
           "requirements-dev.txt)")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import model_check as jmc  # noqa: E402
from repro_torch.core import model_check as tmc  # noqa: E402

TABLES = ("P", "C", "G", "H")


class Interpreter:
    """Interprets ``(op, a, b)`` tuples on one model. Operand ``a``
    picks among the runs or branches an operation can act on, counting
    back from the newest (0 is the newest; a write's 0 is ``main``); an
    operation with nothing to act on is a no-op."""

    def __init__(self, mc, guarded: bool, publication: str):
        self.m = mc.LakehouseModel(guarded=guarded, publication=publication)
        self.runs = []
        self.branches = ["main"]

    def _run(self, k: int, running: bool, done: bool | None = None):
        pool = [r for r in self.runs if (r.status == "running") == running
                and (done is None or r.done == done)]
        return pool[-1 - k % len(pool)] if pool else None

    def apply(self, op) -> str | None:
        """Apply ``op``; the class name of what it raised, if anything."""
        kind, a, b = op
        m = self.m
        try:
            if kind == "begin":
                self.runs.append(m.begin_run(
                    TABLES[:1 + a % 3], mode="direct" if b else "txn"))
            elif kind == "step":
                r = self._run(a, True, done=False)
                if r is not None:
                    m.step_run(r)
            elif kind == "finish":
                r = self._run(a, True, done=True)
                if r is not None:
                    try:
                        m.finish_run(r)
                    except Exception:
                        m.fail_run(r)   # a publication conflict aborts
                        raise
            elif kind == "fail":
                r = self._run(a, True)
                if r is not None:
                    m.fail_run(r)
            elif kind == "abandon":
                r = self._run(a, True)
                if r is not None:
                    m.abandon_run(r)
            elif kind == "gc":
                m.gc(unsafe=bool(b))
            elif kind == "pin":
                names = m.catalog.branches()
                m.pin_branch(names[-1 - a % len(names)])
            elif kind == "branch":
                names = m.catalog.branches()
                self.branches.append(m.actor_branch(
                    names[-1 - a % len(names)], allow_reuse=bool(b % 2)))
            elif kind == "write":
                m.actor_write(self.branches[-a % len(self.branches)],
                              TABLES[b % len(TABLES)])
            elif kind == "merge":
                m.actor_merge(self.branches[-1 - a % len(self.branches)],
                              into="main")
            else:
                raise ValueError(kind)
        except Exception as e:
            return type(e).__name__
        return None

    def observe(self):
        m = self.m
        return (m.torn_runs("main"), m.is_consistent("main"),
                m.stale_publications(), m.collected_live_branches(),
                m.catalog.branches(), m.catalog.tables("main"))

    def bad(self) -> bool:
        m = self.m
        return bool(m.torn_runs("main") or m.stale_publications()
                    or m.collected_live_branches())


def _both(ops, guarded=True, publication="rebase"):
    """Drive both packages through ``ops``; compare after every step.
    Returns the port's interpreter and whether it was ever in a bad
    state."""
    want = Interpreter(jmc, guarded, publication)
    got = Interpreter(tmc, guarded, publication)
    ever_bad = False
    for i, op in enumerate(ops):
        assert got.apply(op) == want.apply(op), (i, op)
        assert got.observe() == want.observe(), (i, op)
        ever_bad |= got.bad()
    return got, ever_bad


# ---------------------------------------------------------------------------
# fixed sequences: test_model_check.py's traces
# ---------------------------------------------------------------------------

FIG3_TOP = [("begin", 2, 1), ("step", 0, 0), ("step", 0, 0),
            ("step", 0, 0), ("finish", 0, 0), ("begin", 2, 1),
            ("step", 0, 0), ("fail", 0, 0)]
FIG3_BOTTOM = [("begin", 2, 0), ("step", 0, 0), ("step", 0, 0),
               ("step", 0, 0), ("finish", 0, 0), ("begin", 2, 0),
               ("step", 0, 0), ("fail", 0, 0)]
# a txn run fails after P; an agent branches off the aborted branch,
# writes X and merges to main
FIG4 = [("begin", 2, 0), ("step", 0, 0), ("fail", 0, 0),
        ("branch", 0, 0), ("write", 1, 7), ("merge", 0, 0)]
# the target moves after begin; the run then publishes
STALE = [("begin", 0, 0), ("step", 0, 0), ("write", 0, 7),
         ("finish", 0, 0)]
# the same table changed on both sides
CONFLICT = [("begin", 0, 0), ("step", 0, 0), ("write", 0, 0),
            ("finish", 0, 0)]
# the pre-fix cron janitor collects a live run's branch
UNSAFE_GC = [("begin", 0, 0), ("step", 0, 0), ("gc", 0, 1),
             ("finish", 0, 0)]
SAFE_GC = [("begin", 0, 0), ("step", 0, 0), ("begin", 1, 0),
           ("step", 0, 0), ("abandon", 1, 0), ("gc", 0, 0),
           ("finish", 0, 0)]
PINS = [("begin", 0, 0), ("step", 0, 0), ("fail", 0, 0), ("pin", 0, 0),
        ("begin", 1, 0), ("step", 0, 0), ("fail", 0, 0),
        ("branch", 0, 1), ("gc", 0, 0), ("merge", 0, 0)]
# an agent branches from a live txn branch (with and without reuse)
LAUNDERING = [("begin", 0, 0), ("step", 0, 0), ("branch", 0, 0),
              ("branch", 0, 1), ("merge", 0, 0)]


@pytest.mark.parametrize("ops,guarded,publication,reaches_bad", [
    (FIG3_TOP, True, "rebase", True),
    (FIG3_BOTTOM, True, "rebase", False),
    (FIG4, False, "rebase", True),
    (FIG4, True, "rebase", False),
    (STALE, True, "stale", True),
    (STALE, True, "rebase", False),
    (CONFLICT, True, "rebase", False),
    (UNSAFE_GC, True, "rebase", True),
    (SAFE_GC, True, "rebase", False),
    (PINS, True, "rebase", False),
    (LAUNDERING, True, "rebase", False),
], ids=["fig3_top", "fig3_bottom", "fig4_unguarded", "fig4_guarded",
        "stale", "stale_rebase", "conflict", "unsafe_gc", "safe_gc",
        "pins", "laundering"])
def test_fixed_traces_agree(ops, guarded, publication, reaches_bad):
    got, ever_bad = _both(ops, guarded, publication)
    assert ever_bad == reaches_bad


def test_stale_counterexample_is_caught_by_the_new_predicate_only():
    got, _ = _both(STALE, True, "stale")
    assert got.m.stale_publications() == ["r0"] and got.m.is_consistent()


# ---------------------------------------------------------------------------
# drawn sequences
# ---------------------------------------------------------------------------

# A drawn trace is a list of episodes: a txn run begins, takes some
# steps while actors branch, write, merge, pin and collect around it,
# then finishes, fails, is abandoned or stays running (so runs overlap),
# and more actor work follows. Only the shipped GC is drawn: the unsafe
# janitor, like direct-mode runs, tears every variant by design (the
# fixed traces above).
ACTOR = st.tuples(st.sampled_from(["branch", "write", "merge", "gc", "pin"]),
                  st.integers(0, 3), st.integers(0, 7)).map(
    lambda op: (op[0], op[1], 0 if op[0] == "gc" else op[2]))
EPISODE = st.tuples(st.integers(0, 2), st.integers(0, 3),
                    st.lists(ACTOR, max_size=3),
                    st.sampled_from(["finish", "fail", "abandon", "none"]),
                    st.lists(ACTOR, max_size=3))


def _expand(episodes):
    ops = []
    for n, steps, during, end, after in episodes:
        ops += [("begin", n, 0)] + [("step", 0, 0)] * steps + during
        ops += [(end, 0, 0)] if end != "none" else []
        ops += after
    return ops


TRACES = st.lists(EPISODE, min_size=1, max_size=6).map(_expand)


@pytest.mark.parametrize("guarded,publication", [
    (True, "rebase"), (False, "rebase"), (True, "stale"), (False, "stale")])
def test_drawn_traces_agree(guarded, publication):
    """Every drawn trace agrees step for step in both packages. The
    guarded rebase variant never reaches a bad state; the same search
    finds one in the unguarded and in the stale variants (so the
    predicates are not vacuous on these traces)."""
    bad = []

    @settings(max_examples=100, derandomize=True, deadline=None,
              database=None, suppress_health_check=[HealthCheck.too_slow])
    @given(ops=TRACES)
    def search(ops):
        bad.append(_both(ops, guarded, publication)[1])

    search()
    assert len(bad) >= 100
    if guarded and publication == "rebase":
        assert not any(bad)
    else:
        assert any(bad)
