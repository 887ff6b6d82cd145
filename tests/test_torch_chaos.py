"""The port's chaos tools (``repro_torch/chaos``) on the port's core,
against ``repro``'s (after ``test_chaos_faults.py``, ``test_catalog_gc.py``
and ``test_chaos_swarm.py``).

Every comparison is exact: a fault plan's decisions, a swarm's drawn
intents, GC reports and checker verdicts are discrete. Swarms with more
than one agent interleave as the scheduler lets them, so across packages
only what is schedule-independent is compared: the intents each
``(agent, idx)`` draws, and a clean ``check_swarm``. One agent replays a
whole history, which is compared record for record.
"""
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import ml_dtypes  # noqa: E402  (shipped with jax)

import repro.chaos as jchaos  # noqa: E402
import repro_torch.chaos as tchaos  # noqa: E402
from repro.core import catalog as jcatalog  # noqa: E402
from repro.core import hooks as jhooks  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core import transactions as jtxn  # noqa: E402
from repro_torch.core import catalog as tcatalog  # noqa: E402
from repro_torch.core import hooks as thooks  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.core import transactions as ttxn  # noqa: E402
from repro_torch.core.errors import TransactionAborted  # noqa: E402
from repro_torch.data import bfloat16  # noqa: E402
from repro_torch.data.tables import Table  # noqa: E402


def _pkg(chaos, catalog, hooks, store, txn):
    return types.SimpleNamespace(
        chaos=chaos, Catalog=catalog.Catalog, Visibility=catalog.Visibility,
        fault_point=hooks.fault_point, MemoryStore=store.MemoryStore,
        TransactionalRun=txn.TransactionalRun, RunRegistry=txn.RunRegistry)


REPRO = _pkg(jchaos, jcatalog, jhooks, jstore, jtxn)
PORT = _pkg(tchaos, tcatalog, thooks, tstore, ttxn)

POINTS = ["txn.begin.post_branch", "txn.commit.pre_merge",
          "txn.commit.post_merge", "store.put", "store.put_ref"]


def _rules(p, spec):
    return tuple(p.chaos.FaultRule(*r) for r in spec)


def _drive(p, plan, sequence):
    """``test_chaos_faults.py``'s replay of a fixed visit sequence."""
    fired = []
    with p.chaos.fault_injection(plan):
        for point in sequence:
            try:
                p.fault_point(point)
            except p.chaos.InjectedFault:
                fired.append((point, "fail"))
            except p.chaos.InjectedCrash:
                fired.append((point, "crash"))
    return fired


# ---------------------------------------------------------------------------
# FaultPlan: the same decisions in both packages
# ---------------------------------------------------------------------------

PLANS = [
    (7, [("txn.commit", "fail", 0.4), ("store.", "crash", 0.3)], None),
    ("s1", [("txn", "fail", 0.5)], None),
    (1, [("", "fail", 1.0)], 3),
    (3, [("txn.commit.pre_merge", "crash", 1.0)], 1),
    (11, [("store.put", "fail", 0.08), ("txn.begin", "crash", 0.03),
          ("txn.commit.post_merge", "crash", 0.10)], 8),
]


@pytest.mark.parametrize("seed,spec,budget", PLANS)
def test_fault_plans_take_the_same_decisions(seed, spec, budget):
    seq = POINTS * 40
    got = []
    for p in (REPRO, PORT):
        plan = p.chaos.FaultPlan(seed, _rules(p, spec), budget=budget)
        got.append((_drive(p, plan, seq), plan.injected,
                    plan.faults_injected))
    assert got[0] == got[1]
    assert got[0][0] or budget == 0     # the rules fire at all


def test_delays_draw_the_same_sleeps():
    slept = {}
    for name, p in (("repro", REPRO), ("port", PORT)):
        slept[name] = []
        plan = p.chaos.FaultPlan(
            5, _rules(p, [("txn", "delay", 0.7, 0.01)]), budget=0,
            sleep=slept[name].append)
        _drive(p, plan, POINTS * 10)
        assert plan.faults_injected == 0
    assert slept["port"] == slept["repro"] and slept["port"]


def test_fault_rule_refuses_what_repros_refuses():
    for p in (REPRO, PORT):
        with pytest.raises(ValueError):
            p.chaos.FaultRule("x", "fail", 1.5)
        with pytest.raises(ValueError):
            p.chaos.FaultRule("x", "explode")


# ---------------------------------------------------------------------------
# FaultyStore over the port's stores: the port's extra surface
# ---------------------------------------------------------------------------

def _stores(tmp_path):
    return {"memory": tstore.MemoryStore(),
            "file": tstore.FileStore(str(tmp_path / "lake"))}


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_faulty_store_round_trips_bfloat16_columns_and_tensors(kind,
                                                               tmp_path):
    inner = _stores(tmp_path)[kind]
    fs = tchaos.FaultyStore(inner)
    g = torch.Generator().manual_seed(0)
    f32 = torch.randn(37, generator=g)
    col = bfloat16.from_bits(f32.bfloat16().view(torch.int16).numpy()
                             .view(np.uint16))
    key = fs.put_array(col)
    back = fs.get_column(key)
    assert bfloat16.is_bfloat16(back.dtype)
    assert back.tobytes() == col.tobytes()
    # the same blob repro writes for the same values
    jkey = jstore.MemoryStore().put_array(
        f32.numpy().astype(ml_dtypes.bfloat16))
    assert key == jkey
    for t in (f32.bfloat16(), f32, torch.arange(5, dtype=torch.int64)):
        got = fs.get_tensor(fs.put_tensor(t))
        assert got.dtype == t.dtype and torch.equal(got, t)
    table = Table({"x": col, "n": np.arange(37, dtype=np.int64)})
    snap = table.to_blobs(fs)
    assert Table.from_blobs(fs, snap).fingerprint() == table.fingerprint()
    assert Table.from_blobs(inner, snap).fingerprint() == \
        table.fingerprint()
    assert hasattr(fs, "sweep_tmp") == (kind == "file")


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_faults_reach_the_ports_store_surface(kind, tmp_path):
    fs = tchaos.FaultyStore(_stores(tmp_path)[kind])
    key = fs.put_tensor(torch.ones(3, dtype=torch.bfloat16))
    plan = tchaos.FaultPlan(0, (tchaos.FaultRule("store.get", "fail"),))
    with tchaos.fault_injection(plan):
        with pytest.raises(tchaos.InjectedFault):
            fs.get_tensor(key)
        with pytest.raises(tchaos.InjectedFault):
            fs.get_column(key)
    plan = tchaos.FaultPlan(0, (tchaos.FaultRule("store.put", "crash"),))
    with tchaos.fault_injection(plan):
        with pytest.raises(tchaos.InjectedCrash):
            fs.put_tensor(torch.zeros(2))
    assert [p for p, _n, _k in plan.injected] == ["store.put"]


# ---------------------------------------------------------------------------
# swarms
# ---------------------------------------------------------------------------

def _config(p, **kw):
    rules = kw.pop("fault_rules", ())
    return p.chaos.SwarmConfig(fault_rules=_rules(p, rules), **kw)


BASE_RULES = [("txn.commit.post_merge", "crash", 0.10),
              ("txn.begin.post_branch", "crash", 0.03),
              ("txn.commit.pre_merge", "delay", 0.20, 0.001),
              ("store.put", "fail", 0.08)]

# test_chaos_swarm.py's regimes
REGIMES = {
    "calm": dict(n_agents=6, runs_per_agent=2, gc_every=3),
    "contended": dict(n_agents=8, runs_per_agent=2, hot_tables=1,
                      p_contended=0.8, p_multi=0.0, p_violate=0.0,
                      p_abandon=0.0, p_reuse=0.0, gc_every=4,
                      fault_rules=[("txn.commit.pre_merge", "delay", 0.8,
                                    0.003)]),
    "faulted": dict(n_agents=6, runs_per_agent=2, gc_every=3,
                    use_store=True, fault_rules=BASE_RULES,
                    fault_budget=8),
    "hostile": dict(n_agents=6, runs_per_agent=2, gc_every=2,
                    use_store=True, p_violate=0.2, p_abandon=0.15,
                    p_reuse=0.2,
                    fault_rules=BASE_RULES + [
                        ("txn.commit.pre_rebase", "crash", 0.05),
                        ("txn.commit.post_rebase", "crash", 0.05)],
                    fault_budget=12),
}


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("batch", range(3))
def test_port_swarms_are_linearizable(regime, batch):
    """``test_chaos_swarm.py``'s 240 seeded schedules, on the port."""
    for i in range(20):
        seed = f"{regime}-{batch * 20 + i}"
        res = tchaos.run_swarm(_config(PORT, seed=seed, **REGIMES[regime]))
        violations = tchaos.check_swarm(res)
        assert not violations, (
            f"seed {seed!r} (replayable): {violations}\n"
            f"injected={res.plan.injected}")
        cfg = REGIMES[regime]
        assert len(res.records) == cfg["n_agents"] * cfg["runs_per_agent"]


def _drawn(res):
    return sorted((r.agent, r.idx, r.run_id, r.intent) for r in res.records)


@pytest.mark.parametrize("regime", ["calm", "hostile"])
@pytest.mark.parametrize("seed", [0, 5, "replay"])
def test_swarms_draw_the_same_intents(regime, seed):
    """``(agent, idx, intent)`` is drawn from ``(seed, agent, run)``
    alone, so it is the same in both packages whatever the schedule
    (reuse falls back to disjoint when nothing was aborted yet, which
    depends on the schedule: both count as one draw)."""
    def draw(p):
        res = p.chaos.run_swarm(_config(p, seed=seed, **REGIMES[regime]))
        return [(a, i, rid, "reuse" if it in ("reuse", "disjoint")
                 else it) for a, i, rid, it in _drawn(res)]
    assert draw(PORT) == draw(REPRO)


@pytest.mark.parametrize("seed", ["replay", 3, 11])
def test_single_agent_swarm_replays_repros_history(seed):
    """One agent runs sequentially: the whole history, the fault log,
    the GC reports and the final catalog equal ``repro``'s."""
    def run(p):
        res = p.chaos.run_swarm(_config(
            p, n_agents=1, runs_per_agent=8, seed=seed, use_store=True,
            fault_rules=BASE_RULES, gc_every=3, p_abandon=0.2))
        return ([dataclasses.astuple(r) for r in res.records],
                res.plan.injected, res.gc_reports, res.final_gc,
                res.catalog.tables("main"), res.catalog.branches(),
                [c.id for c in res.catalog.log("main", limit=1000)])
    got, want = run(PORT), run(REPRO)
    assert got[0] == want[0] and got[1] == want[1]
    assert [dataclasses.astuple(g) for g in got[2]] == \
        [dataclasses.astuple(w) for w in want[2]]
    assert dataclasses.astuple(got[3]) == dataclasses.astuple(want[3])
    assert got[4:] == want[4:]


@pytest.mark.parametrize("point", ["txn.begin.post_branch",
                                   "txn.commit.pre_merge",
                                   "txn.commit.post_merge", "store.put"])
def test_crash_point_recovery_on_the_port(point):
    res = tchaos.run_swarm(_config(
        PORT, n_agents=3, runs_per_agent=2, seed=f"crash-{point}",
        use_store=True, fault_rules=[(point, "crash", 1.0)],
        fault_budget=3))
    assert not tchaos.check_swarm(res)
    assert [r for r in res.records if r.outcome == "crashed"]
    with ttxn.TransactionalRun(res.catalog, "main", run_id="after") as txn:
        txn.write_tables({"after": "s@after"})
        txn.verify(lambda read: read("after"))
    assert res.catalog.tables("main")["after"] == "s@after"
    for b in res.catalog.branches():
        assert res.catalog.branch_info(b).visibility not in (
            tcatalog.Visibility.TXN, tcatalog.Visibility.ABORTED)


# ---------------------------------------------------------------------------
# the checker: the same verdicts on the same bad histories
# ---------------------------------------------------------------------------

def _good_run(p, cat, rid, tables):
    with p.TransactionalRun(cat, "main", run_id=rid,
                            registry=p.RunRegistry()) as txn:
        txn.write_tables(tables)
        txn.verify(lambda read: None)
    return txn.final_commit.id


def _rec(p, **kw):
    base = dict(agent=0, idx=0, run_id="r0", intent="disjoint")
    base.update(kw)
    return p.chaos.AgentRecord(**base)


def _partial(p):
    cat = p.Catalog()
    cid = _good_run(p, cat, "r0", {"a": "a@r0"})
    return cat, [_rec(p, outcome="committed", final_commit=cid,
                      verified_head=cid, tables={"a": "a@r0", "b": "b@r0"})]


def _early(p):
    cat = p.Catalog()
    cat.write_table("main", "a", "a@r0")
    cid = _good_run(p, cat, "r0", {"a": "a@r0", "b": "b@r0"})
    return cat, [_rec(p, outcome="committed", final_commit=cid,
                      verified_head=cid, tables={"a": "a@r0", "b": "b@r0"})]


def _leak(p):
    cat = p.Catalog()
    cat.write_table("main", "a", "a@dead")
    return cat, [_rec(p, run_id="dead", outcome="aborted",
                      tables={"a": "a@dead"})]


def _aborted_on_chain(p):
    cat = p.Catalog()
    _good_run(p, cat, "dead", {"a": "a@dead"})
    return cat, [_rec(p, run_id="dead", outcome="aborted",
                      tables={"a": "a@dead"})]


def _unverified(p):
    cat = p.Catalog()
    cid = _good_run(p, cat, "r0", {"a": "a@r0"})
    return cat, [_rec(p, outcome="committed", final_commit=cid,
                      verified_head="somethingelse", tables={"a": "a@r0"})]


def _mystery(p):
    cat = p.Catalog()
    _good_run(p, cat, "ghost", {"a": "a@ghost"})
    return cat, []


def _guardrail(p):
    return p.Catalog(), [
        _rec(p, run_id="q0", outcome="released", illegal_merge=True),
        _rec(p, run_id="l0", outcome="branch_lost", error="gone")]


def _lost_ack(p):
    cat = p.Catalog()
    txn = p.TransactionalRun(cat, "main", run_id="r0",
                             registry=p.RunRegistry())
    txn.begin()
    txn.write_tables({"a": "a@r0", "b": "b@r0"})
    plan = p.chaos.FaultPlan(0, _rules(p, [("txn.commit.post_merge",
                                            "crash", 1.0)]))
    with p.chaos.fault_injection(plan):
        with pytest.raises(p.chaos.InjectedCrash):
            txn.commit()
    return cat, [_rec(p, outcome="crashed", branch=txn.branch,
                      tables={"a": "a@r0", "b": "b@r0"}),
                 _rec(p, run_id="r1", outcome="crashed",
                      tables={"c": "c@r1"})]


@pytest.mark.parametrize("history,flagged", [
    (_partial, "partial publication"), (_early, "BEFORE publication"),
    (_leak, "leaked"), (_aborted_on_chain, "are on 'main'"),
    (_unverified, "unverified state"), (_mystery, "mystery publication"),
    (_guardrail, "Fig. 4"), (_lost_ack, None)])
def test_checker_gives_repros_verdicts(history, flagged):
    verdicts = []
    for p in (REPRO, PORT):
        cat, records = history(p)
        verdicts.append(p.chaos.check_history(cat, records))
    assert verdicts[0] == verdicts[1]
    if flagged is None:
        assert verdicts[1] == []
    else:
        assert any(flagged in v for v in verdicts[1]), verdicts[1]


# ---------------------------------------------------------------------------
# GC under a live set (test_catalog_gc.py's stories, in both packages)
# ---------------------------------------------------------------------------

def _txn_branch(p, cat, rid, tables=None):
    b = f"txn/{rid}"
    cat.create_branch(b, "main", visibility=p.Visibility.TXN,
                      owner_run=rid)
    for t, s in (tables or {"t": f"s@{rid}"}).items():
        cat.write_table(b, t, s, run_id=rid, _system=True)
    return b


def _gc_story(p):
    """Live, dead, young, aborted, pinned, quarantined and user branches,
    and a tag, through five GC passes at fixed clocks."""
    cat = p.Catalog()
    cat.write_table("main", "t", "s0")
    cat.create_branch("feature", "main")
    cat.tag("v1", "main")
    for rid in ("live", "dead", "young"):
        _txn_branch(p, cat, rid)
    aborted = []
    for rid in ("a1", "a2", "bad"):
        aborted.append(_txn_branch(p, cat, rid))
        cat.mark(aborted[-1], p.Visibility.ABORTED, _system=True)
    cat.create_branch("retry", aborted[2], allow_reuse=True)
    now = max(cat.branch_info(b).updated_at for b in cat.branches())
    pin = cat.pin(aborted[0])
    reports = [cat.gc(live_runs=["live"], grace_s=300.0, now=now + 10,
                      dry_run=True),
               cat.gc(live_runs=["live"], grace_s=300.0, now=now + 10)]
    reports.append(cat.gc(live_runs=["live"], grace_s=300.0,
                          now=now + 301))
    cat.unpin(pin)
    reports.append(cat.gc(live_runs=["live"], grace_s=0.0, now=now + 302))
    reports.append(cat.gc(live_runs=(), grace_s=0.0, now=now + 303))
    return ([dataclasses.astuple(r) for r in reports], cat.branches(),
            cat.tables("main"))


def test_gc_under_a_live_set_collects_what_repros_collects():
    got, want = _gc_story(PORT), _gc_story(REPRO)
    assert got == want
    collected = [n for r in got[0][1:] for n, _ in r[0]]
    assert "txn/live" in collected[-1:] and "txn/dead" in collected
    assert got[1] == ["feature", "main", "retry"]


def test_gc_recovers_crashed_publication_debris_as_repro_does():
    outs = []
    for p in (REPRO, PORT):
        cat, reg = p.Catalog(), p.RunRegistry()
        txn = p.TransactionalRun(cat, "main", run_id="crasher",
                                 registry=reg)
        txn.begin()
        txn.write_tables({"t": "s@crasher"})
        plan = p.chaos.FaultPlan(0, _rules(p, [("txn.commit.post_merge",
                                                "crash", 1.0)]))
        with p.chaos.fault_injection(plan):
            with pytest.raises(p.chaos.InjectedCrash):
                txn.commit()
        status = reg.get_run("crasher").status
        report = cat.gc(live_runs=[])
        outs.append((status, dataclasses.astuple(report),
                     cat.tables("main"), cat.branches()))
    assert outs[0] == outs[1]
    assert outs[1][0] == "running" and outs[1][2] == {"t": "s@crasher"}
    assert "txn/crasher" not in outs[1][3]


# ---------------------------------------------------------------------------
# R2 (ROADMAP Queue 3): the port keeps repro's behaviour at the seam
# ---------------------------------------------------------------------------

def test_post_merge_fail_ends_as_in_repro():
    """A ``fail`` injected right after the merge, one run, no threads:
    the run's tables are on ``main`` yet the run aborts. That is R2, a
    fault of the shared core (``core/transactions.py``'s ``except
    Exception`` around the merge); the port reproduces it, as a port
    must, rather than fixing it alone."""
    ends = []
    for p in (REPRO, PORT):
        cat, reg = p.Catalog(), p.RunRegistry()
        txn = p.TransactionalRun(cat, "main", run_id="r0", registry=reg)
        txn.begin()
        txn.write_tables({"a": "a@r0"})
        txn.verify(lambda read: read("a"))
        plan = p.chaos.FaultPlan(0, _rules(p, [("txn.commit.post_merge",
                                                "fail")]))
        with p.chaos.fault_injection(plan):
            with pytest.raises(Exception) as info:
                txn.commit()
        ends.append((type(info.value).__name__,
                     type(info.value.__cause__).__name__,
                     reg.get_run("r0").status,
                     cat.tables("main").get("a") == "a@r0",
                     cat.branch_info(txn.branch).visibility.value))
    assert ends[0] == ends[1]
    assert ends[1] == ("TransactionAborted", "InjectedFault", "aborted",
                       True, "aborted")
    assert issubclass(TransactionAborted, Exception)


def test_r2_example_reproduces_on_the_ports_swarm():
    """``.hypothesis/patches/2026-10-16--324d4a50.patch``'s example, run
    once in each package: the same violations (up to which of the two
    agents drew the fault)."""
    def violations(p):
        res = p.chaos.run_swarm(_config(
            p, n_agents=2, runs_per_agent=1, seed=0, hot_tables=1,
            p_contended=0.0, p_multi=0.0, p_violate=0.0, p_abandon=0.0,
            p_reuse=0.0, gc_every=0, gc_grace_s=0.0, use_store=False,
            fault_rules=[("txn.commit.post_merge", "fail", 0.25, 0.001)],
            fault_budget=None, max_publish_attempts=12,
            publish_backoff_s=0.001, target="main"))
        # which agent drew the fault, and so the ids, is the schedule's
        out = [re.sub(r"sw0-a[01]r0|\b[0-9a-f]{8}\b|\ba[01]\b", "_", v)
               for v in p.chaos.check_swarm(res)]
        return sorted(out), res.outcomes(), res.plan.injected
    got, want = violations(PORT), violations(REPRO)
    assert got == want
    assert got[0] and got[1] == {"aborted": 1, "committed": 1}
