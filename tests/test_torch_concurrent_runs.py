"""The port's transactional core under threads (after
``tests/test_concurrent_runs.py`` and ``tests/test_transactions.py``),
checked by the port's ``chaos.check_history``.

Every interleaving that a check depends on is forced with barriers: all
runs begin on the same ``main`` and none publishes before all have
written, so conflicts and rebases happen whatever the scheduler does.
No check depends on threads contending on their own.

``Client.run`` runs on the port's CPU backends. The scenarios of
``repro_torch.examples.concurrent_runs`` (the group-bys of the card's
phase 9, at SF 0.01) run on ``torch_auto`` over the CPU, with its device
threshold lowered so the group-bys take the ``torch`` backend's path
through the segment wrappers. Their tables are held against the same
nodes built with ``repro``'s pipeline and planner and run serially
through ``repro``'s ``Client.run`` (its default backend, ``vectorized``)
on the same ``lineitem``: exactly (integer SUM, COUNT, and MIN/MAX; the
nodes have no float SUM). The port's ``vectorized`` tables, which
``chip_smoke.py`` holds the card's runs to, equal ``repro``'s as well.
"""
import threading

import numpy as np
import pytest

from repro.core.runner import Client as JClient
from repro.core import schema as JS
from repro.core.dag import Pipeline as JPipeline
from repro.core.planner import plan as jplan
from repro.data.tables import Table as JTable, col as jcol, lit as jlit
from repro_torch import exec as exec_backends
from repro_torch.chaos import AgentRecord, check_history
from repro_torch.core import schema as S
from repro_torch.core.catalog import Catalog, Visibility
from repro_torch.core.dag import Pipeline
from repro_torch.core.errors import PublicationConflict, TransactionAborted
from repro_torch.core.planner import plan
from repro_torch.core.quality import expect_not_null, expect_row_count
from repro_torch.core.runner import Client
from repro_torch.core.transactions import RunRegistry, TransactionalRun
from repro_torch.data.tables import Table, col
from repro_torch.examples import concurrent_runs as cr
from repro_torch.exec import torch_auto, torch_backend
from repro_torch.exec.torch_auto import TorchAutoBackend

K = cr.AGENTS


def _spawn(n, fn):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _source(T):
    return T({"k": np.array(["a", "b", "c"], dtype=object),
              "v": np.arange(3, dtype=np.int64)})


def _pipeline(Sch, Pipe, c, i):
    Src = Sch.Schema.of("Src", k=str, v=int)
    Out = Sch.Schema.of("Out", k=str, v=int)
    p = Pipe(f"worker{i}")
    p.source("src_table", Src)

    @p.node(name=f"out_{i}")
    def out_node(df: Src = "src_table") -> Out:
        return df.select([c("k"), (c("v") * (i + 1)).alias("v")])

    return p


def _client_runs(client, plans, verifiers):
    """K ``Client.run``s behind a barrier in their verifiers."""
    gate = threading.Barrier(len(plans), timeout=60)
    results = {}

    def worker(i):
        seen = []

        def at_gate(_t):
            if not seen:
                seen.append(True)
                gate.wait()
        results[i] = client.run(
            plans[i], "main",
            verifiers={f"out_{i}": [at_gate, *verifiers]},
            max_publish_attempts=K + 2)

    _spawn(len(plans), worker)
    return results


def _committed_records(results):
    return [AgentRecord(agent=i, idx=0, run_id=r.state.run_id,
                        intent="disjoint", outcome=r.state.status,
                        tables=dict(r.tables),
                        final_commit=r.state.final_commit,
                        verified_head=r.state.verified_head)
            for i, r in sorted(results.items())]


# ---------------------------------------------------------------------------
# disjoint outputs: all K runs publish, rebasing past each other
# ---------------------------------------------------------------------------

def test_eight_concurrent_client_runs_all_publish():
    client = Client()
    client.write_source_table("main", "src_table", _source(Table))
    base = len(client.catalog.log("main", limit=1000))
    plans = [plan(_pipeline(S, Pipeline, col, i)) for i in range(K)]
    with exec_backends.use_backend("vectorized"):
        results = _client_runs(client, plans, [expect_row_count(1, 10),
                                               expect_not_null("k")])
    tables = client.catalog.tables("main")
    assert all(f"out_{i}" in tables for i in range(K))
    for res in results.values():
        st = res.state
        assert st.status == "committed"
        assert st.final_commit == st.verified_head is not None
    log = client.catalog.log("main", limit=1000)
    assert len(log) == base + K
    assert {c.run_id for c in log[:K]} == {
        r.state.run_id for r in results.values()}
    # the gate made all K begin on one head: K - 1 had to rebase, and a
    # rebase past a sibling that left the inputs alone re-executes nothing
    assert sum(len(r.rebase_reexecutions) for r in results.values()) \
        >= K - 1
    assert sum(sum(r.rebase_reexecutions) for r in results.values()) == 0
    assert client.catalog.branches() == ["main"]
    assert check_history(client.catalog, _committed_records(results)) == []


def test_concurrent_runs_publish_repros_snapshots():
    """The same eight runs in ``repro``: the port publishes the same
    snapshot of every table (the blob layout is shared)."""
    def final(Cl, Sch, Pipe, c, T, plan_):
        client = Cl()
        client.write_source_table("main", "src_table", _source(T))
        plans = [plan_(_pipeline(Sch, Pipe, c, i)) for i in range(K)]
        _client_runs(client, plans, [])
        return client.catalog.tables("main")

    with exec_backends.use_backend("vectorized"):
        got = final(Client, S, Pipeline, col, Table, plan)
    want = final(JClient, JS, JPipeline, jcol, JTable, jplan)
    assert got == want and len(got) == K + 1


# ---------------------------------------------------------------------------
# the same table: exactly one run wins; the rest abort cleanly
# ---------------------------------------------------------------------------

def _fighters(cat, reg, n, table_of):
    barrier = threading.Barrier(n, timeout=60)
    outcomes = {}

    def worker(i):
        txn = TransactionalRun(cat, "main", registry=reg,
                               run_id=f"run{i}",
                               max_publish_attempts=2 * n).begin()
        txn.write_table(table_of(i), f"{table_of(i)}-run{i}")
        txn.verify(lambda read: read(table_of(i)))
        barrier.wait()          # everyone wrote before anyone publishes
        try:
            outcomes[i] = ("committed", txn.commit().id, txn)
        except TransactionAborted:
            outcomes[i] = ("aborted", None, txn)

    _spawn(n, worker)
    records = []
    for i, (status, _cid, txn) in sorted(outcomes.items()):
        st = reg.get_run(txn.run_id)
        records.append(AgentRecord(
            agent=i, idx=0, run_id=txn.run_id, intent="contended",
            outcome=status, tables={table_of(i): f"{table_of(i)}-run{i}"},
            branch=txn.branch, final_commit=st.final_commit,
            verified_head=st.verified_head))
    return outcomes, records


def test_concurrent_same_table_runs_serialize():
    cat, reg = Catalog(), RunRegistry()
    cat.write_table("main", "T", "t0")
    outcomes, records = _fighters(cat, reg, K, lambda i: "T")
    committed = {i: v for i, v in outcomes.items() if v[0] == "committed"}
    assert len(committed) == 1
    (winner, (_, cid, wtxn)), = committed.items()
    assert cat.read_table("main", "T") == f"T-run{winner}"
    assert cat.head("main").id == cid
    assert set(wtxn.verifier_heads) == {cid}
    for i, (status, _, txn) in outcomes.items():
        if status == "aborted":
            assert cat.branch_info(txn.branch).visibility \
                is Visibility.ABORTED
            assert cat.read_table(txn.branch, "T") == f"T-run{i}"
    assert check_history(cat, records) == []


@pytest.mark.parametrize("round_", range(3))
def test_mixed_contention_rounds(round_):
    """Half the runs write private tables (must publish), half fight
    over one shared table (exactly one winner per round)."""
    cat, reg = Catalog(), RunRegistry()
    cat.write_table("main", "shared", "s0")
    outcomes, records = _fighters(
        cat, reg, K, lambda i: f"private_{i}" if i % 2 == 0 else "shared")
    assert all(outcomes[i][0] == "committed" for i in range(0, K, 2))
    winners = [i for i in range(1, K, 2) if outcomes[i][0] == "committed"]
    assert len(winners) == 1
    assert cat.read_table("main", "shared") == f"shared-run{winners[0]}"
    for status, cid, txn in outcomes.values():
        if status == "committed":
            assert set(txn.verifier_heads) == {cid}
    assert check_history(cat, records) == []


def test_checker_catches_a_published_loser():
    """Not vacuous: calling the winner of a fight aborted is flagged."""
    cat, reg = Catalog(), RunRegistry()
    cat.write_table("main", "T", "t0")
    _outcomes, records = _fighters(cat, reg, 2, lambda i: "T")
    for r in records:
        r.outcome = "aborted"
    assert any("leaked" in v for v in check_history(cat, records))


def test_publication_conflict_is_transaction_aborted():
    assert issubclass(PublicationConflict, TransactionAborted)


# ---------------------------------------------------------------------------
# the card's phase 9 scenarios, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem():
    return cr.lineitem_with_suppkey(0.01, seed=0)


def _jagent_plan(i):
    """``cr.agent_plan(i)`` built with ``repro``'s modules."""
    key = "l_orderkey" if i % 2 == 0 else "l_suppkey"
    Lines = JS.Schema.of("Lines", l_orderkey="int64", l_suppkey="int64",
                         l_quantity="int64", l_extendedprice="float64")
    Agg = JS.Schema.of("Agg", key="int64", sum_qty="int64",
                       n_lines="int64", min_price="float64",
                       max_price="float64")
    p = JPipeline(f"agent{i}")
    p.source("lineitem", Lines)

    @p.node(name=f"agg_{i}")
    def aggregate(li: Lines = "lineitem") -> Agg:
        rows = li.select([jcol(key).alias("key"),
                          (jcol("l_quantity") * jlit(i + 1)).alias("qty"),
                          jcol("l_extendedprice")])
        return rows.group_by(["key"]).agg(
            ("sum", "qty", "sum_qty"), ("count", "qty", "n_lines"),
            ("min", "l_extendedprice", "min_price"),
            ("max", "l_extendedprice", "max_price"))

    return jplan(p)


@pytest.fixture(scope="module")
def want(lineitem):
    """``repro``'s tables: each agent's node run alone through its
    ``Client.run``, as the port's ``Table`` (columns and validity)."""
    client = JClient()
    client.write_source_table("main", "lineitem", JTable(lineitem))
    out = {}
    for i in range(K):
        client.run(_jagent_plan(i), "main")
        t = client.read_table("main", f"agg_{i}")
        out[f"agg_{i}"] = Table._from_cols(t._to_cols())
    return out


def test_port_reference_equals_repros(lineitem, want):
    """The port's serial ``vectorized`` runs (``cr.reference``, what
    the card's phase 9 is held to) equal ``repro``'s, bit for bit."""
    got = cr.reference(lineitem, [cr.agent_plan(i) for i in range(K)])
    assert set(got) == set(want)
    for name in want:
        cr.same_columns(got[name], want[name], name)
        assert got[name].num_rows == (15_000 if name[-1] in "0246"
                                      else 100)


@pytest.fixture
def torch_path(monkeypatch):
    """torch_auto on the CPU, its device row lowered to SF 0.01; counts
    the group-bys that reach the segment wrappers."""
    monkeypatch.setattr(torch_auto, "DEVICE_ROWS", 1_000)
    calls = {"sum": 0, "reduce": 0}
    lock = threading.Lock()

    def counting(name, fn):
        def wrapper(*a, **kw):
            with lock:
                calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(torch_backend, "masked_segment_sum", counting(
        "sum", torch_backend.masked_segment_sum))
    monkeypatch.setattr(torch_backend, "masked_segment_reduce", counting(
        "reduce", torch_backend.masked_segment_reduce))
    with exec_backends.use_backend(TorchAutoBackend(device="cpu")):
        yield calls


def test_suppkey_follows_tpch(lineitem):
    s = lineitem["l_suppkey"]
    assert s.dtype == np.int64 and len(s) == len(lineitem["l_orderkey"])
    assert s.min() >= 1 and s.max() <= 100      # S = SF * 10,000
    again = cr.lineitem_with_suppkey(0.01, seed=0)["l_suppkey"]
    assert np.array_equal(again, s)


def test_disjoint_agents(lineitem, want, torch_path):
    out = cr.disjoint(lineitem, want=want)
    assert out["committed"] == K and out["rebases"] >= K - 1
    assert out["rebase_reexecutions"] == 0
    # one SUM and COUNT launch and two MIN/MAX a run: 8 runs, no rebase
    # re-executed anything
    assert torch_path == {"sum": K, "reduce": 2 * K}


def test_same_table_agents(lineitem, want, torch_path):
    out = cr.same_table(lineitem, want=want)
    assert out["committed"] == 1 and {out["winner"], out["loser"]} == {1, 3}


def test_crashed_agent(lineitem, want, torch_path):
    out = cr.crash_one(lineitem, seed=0, want=want)
    assert out["committed"] == K - 1
    assert out["collected"] == [f"txn/{out['crashed_run']}"]


def test_scenarios_fail_loudly(lineitem, want, torch_path):
    """A published table that differs from ``vectorized``'s fails the
    scenario."""
    wrong = dict(want)
    wrong["agg_2"] = want["agg_0"]
    with pytest.raises(cr.CheckFailed, match="agg_2"):
        cr.disjoint(lineitem, want=wrong)
