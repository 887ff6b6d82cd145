"""The port's query path: ``Client.sql`` -> compiler -> optimizer ->
backend, against ``repro``'s.

The same generated TPC-H catalog (SF 0.001: 6,001 lineitem rows, 1,500
orders) and a NULL-bearing pair of tables go into a ``repro`` client and
a port client. Each query runs through ``repro``'s ``Client.sql`` on its
``vectorized`` backend and through the port's on its ``vectorized``
backend, with the same explicit pass list (without ``partial_agg``, so
``repro`` never reaches its mesh code): the result fingerprints are
equal, float sums included, because both run the same host code.

The port's card backends (``partitioned``, and ``torch_auto`` with its
thresholds lowered so that this small data takes the card rows) run on
the CPU and are held against the port's ``vectorized`` result:
integers, strings and validity exact, float SUM at rtol 1e-9 (the
summation-order carve-out). Optimized plans are held against
unoptimized ones the same way.

With ``partitioned`` registered over 8 CPU cards (in process, as
``repro``'s forced 8-device host mesh), the ``partial_agg`` pass
rewrites as ``repro``'s does on its mesh, and the rewritten plans
publish what the unoptimized ones do.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import repro.exec as jexec  # noqa: E402
from repro.core.runner import Client as JClient  # noqa: E402
from repro.data.tables import Table as JTable  # noqa: E402
from test_exec_backends import random_table  # noqa: E402

from repro_torch import exec as exec_backends  # noqa: E402
from repro_torch.core import logical as L  # noqa: E402
from repro_torch.core import schema as S  # noqa: E402
from repro_torch.core.dag import Pipeline  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.core.runner import Client  # noqa: E402
from repro_torch.data.tables import Table, _ColumnData, col  # noqa: E402
from repro_torch.examples import tpch  # noqa: E402
from repro_torch.exec import torch_auto, use_backend  # noqa: E402
from repro_torch.exec.partitioned import PartitionedBackend  # noqa: E402
from repro_torch.exec.stats import TableStats  # noqa: E402
from repro_torch.exec.torch_auto import TorchAutoBackend  # noqa: E402
from repro_torch.exec.vectorized import VectorizedBackend  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.optimizer import optimize, passes  # noqa: E402

PASSES = ("filter_pushdown", "join_reorder", "column_pruning",
          "probe_fusion")
GROUPED = ("SELECT o_custkey, SUM(l_quantity) AS qty, "
           "SUM(l_extendedprice) AS revenue, COUNT(l_quantity) AS n_lines "
           "FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
           "{where}GROUP BY o_custkey")
QUERIES = {
    "join_group": GROUPED.format(where=""),
    "join_where": GROUPED.format(where="WHERE l_discount >= 0.05 "),
    "left_join": ("SELECT o_orderkey, o_custkey, l_quantity FROM orders "
                  "LEFT JOIN lineitem ON o_orderkey = l_orderkey "
                  "WHERE o_totalprice > 200000"),
    "order_limit": ("SELECT o_custkey, SUM(l_quantity) AS qty FROM lineitem "
                    "JOIN orders ON l_orderkey = o_orderkey "
                    "WHERE l_quantity > 10 GROUP BY o_custkey "
                    "ORDER BY qty DESC, o_custkey LIMIT 25"),
    "null_string_key": ("SELECT a.ki, a.ks, a.v32, b.f FROM t1 a JOIN t2 b "
                        "ON a.ks = b.ks WHERE b.v32 > 0"),
    "null_two_keys": ("SELECT a.ki, a.ks, b.f FROM t1 a LEFT JOIN t2 b "
                      "ON a.ki = b.ki AND a.ks = b.ks"),
}
FLOATS = {"revenue"}


def _data():
    data = tpch.generate(0.001, seed=0)
    for name, seed, n in (("t1", 1, 300), ("t2", 2, 150)):
        t = random_table(n, seed)
        data[name] = {c: t._data[c] for c in ("ki", "ks", "f", "v32")}
    return data


@pytest.fixture(scope="module")
def clients():
    data = _data()
    jc, pc = JClient(), Client()
    for name, cols in data.items():
        if name.startswith("t"):     # random_table columns: keep validity
            jt, pt = JTable({}), Table({})
            for c, d in cols.items():
                jt._data[c] = d
                pt._data[c] = _ColumnData(
                    d.values.copy(),
                    None if d.valid is None else d.valid.copy())
        else:
            jt, pt = JTable(cols), Table(cols)
        jc.write_source_table("main", name, jt)
        pc.write_source_table("main", name, pt)
    return jc, pc


def _repro(jc, query, **kw):
    with jexec.use_backend("vectorized"):
        return jc.sql(query, optimizer_passes=PASSES, **kw)


def _port(pc, query, backend="vectorized", **kw):
    kw.setdefault("optimizer_passes", PASSES)
    with use_backend(backend):
        return pc.sql(query, cache=False, **kw)


def assert_tables_equal(a, b, floats=FLOATS):
    assert a.column_names() == b.column_names()
    assert len(a) == len(b)
    for c in a.column_names():
        assert a.validity(c).tolist() == b.validity(c).tolist(), c
        x, y = a.column(c), b.column(c)
        assert x.dtype == y.dtype, c
        if c in floats:
            m = a.validity(c)
            np.testing.assert_allclose(x[m], y[m], rtol=1e-9, atol=0)
        else:
            assert [repr(v) for v in x] == [repr(v) for v in y], c


@pytest.fixture
def low_thresholds(monkeypatch):
    """Small data takes the card rows of torch_auto's table."""
    monkeypatch.setattr(torch_auto, "SHARD_ROWS", 100)
    monkeypatch.setattr(torch_auto, "DEVICE_ROWS", 100)


# ---------------------------------------------------------------------------
# the port against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(QUERIES))
def test_port_sql_matches_repro(clients, name):
    jc, pc = clients
    want = _repro(jc, QUERIES[name])
    got = _port(pc, QUERIES[name])
    assert len(got.table) > 0
    assert got.table.column_names() == want.table.column_names()
    assert got.fingerprint() == want.fingerprint()
    # the same rewrites fired, in the same order
    assert got.plan.steps[0].provenance == want.plan.steps[0].provenance
    assert (got.plan.steps[-1].logical.describe()
            == want.plan.steps[-1].logical.describe())


@pytest.mark.parametrize("backend", ["partitioned", "torch_auto"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_card_backends_match_vectorized(clients, low_thresholds, name,
                                        backend):
    _, pc = clients
    be = (PartitionedBackend(device="cpu") if backend == "partitioned"
          else TorchAutoBackend(device="cpu"))
    want = _port(pc, QUERIES[name]).table
    assert_tables_equal(_port(pc, QUERIES[name], be).table, want)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_optimized_matches_unoptimized(clients, low_thresholds, name):
    _, pc = clients
    be = TorchAutoBackend(device="cpu")
    fast = _port(pc, QUERIES[name], be, optimizer_passes=None)
    slow = _port(pc, QUERIES[name], be, optimizer_passes=())
    assert_tables_equal(fast.table, slow.table)
    assert slow.plan.steps[0].provenance == ()


def test_explain_shows_probe_fusion_into_the_probe_side(clients):
    _, pc = clients
    r = _port(pc, QUERIES["join_where"], PartitionedBackend(device="cpu"),
              optimizer_passes=None)
    text = r.describe()
    assert "probe_fusion: fused 1 filter(s) into join probe masks" in text
    join = r.plan.steps[-1].logical.child
    while not isinstance(join, L.Join):
        join = join.child
    assert join.left.scan_tables() == {"lineitem"}
    assert join.left_pred is not None and join.right_pred is None


def test_rerun_at_the_same_commit_is_a_pure_cache_hit(clients):
    _, pc = clients
    q = QUERIES["join_group"]
    with use_backend(PartitionedBackend(device="cpu")):
        first = pc.sql(q)
        again = pc.sql(q.replace("SELECT o_custkey", "SELECT  o_custkey"))
    assert again.executed == () and again.cached == ("query",)
    assert again.fingerprint() == first.fingerprint()


def test_pipeline_sql_query_matches_repro(clients):
    """An SQL node inside a transactional run, downstream of a
    declarative node, published in one commit."""
    from repro.core import schema as JS
    from repro.core.dag import Pipeline as JPipeline
    from repro.core.planner import plan as jplan
    from repro.data.tables import col as jcol

    def build(api_S, api_Pipeline, api_col):
        O = api_S.Schema.of("O", o_orderkey="int64", o_custkey="int64",
                            o_totalprice="float64",
                            o_orderdate="datetime")
        p = api_Pipeline("q")
        p.source("orders", O)
        p.sql(name="big", inputs={"o": "orders"},
              input_schemas={"o": O}, output_schema=O,
              filter_expr=api_col("o_totalprice") > 150000.0)
        p.sql_query(name="per_cust", query=(
            "SELECT o_custkey, COUNT(o_orderkey) AS n FROM big "
            "GROUP BY o_custkey"))
        return p

    jc, pc = clients
    fps = []
    for client, S_, P_, col_, plan_, use in (
            (jc, JS, JPipeline, jcol, jplan, jexec.use_backend),
            (pc, S, Pipeline, col, plan, use_backend)):
        branch = f"sqlq{len(fps)}"
        client.create_branch(branch, from_ref="main")
        with use("vectorized"):
            res = client.run(plan_(build(S_, P_, col_)), branch)
        assert res.state.status == "committed"
        fps.append({t: client.read_table(branch, t).fingerprint()
                    for t in ("big", "per_cust")})
    assert fps[0] == fps[1]


# ---------------------------------------------------------------------------
# partial aggregation on one card (the repair of the backend name)
# ---------------------------------------------------------------------------

def test_partial_strategy_asks_for_the_partitioned_backend(monkeypatch):
    """``Aggregate(strategy="partial")`` runs on ``partitioned``, the
    port's name for the backend of per-partition partials."""
    asked = []
    used = []
    cpu = PartitionedBackend(device="cpu")
    real = cpu.group_by_agg

    def spy_group_by(*a, **k):
        used.append(cpu.name)
        return real(*a, **k)

    monkeypatch.setattr(cpu, "group_by_agg", spy_group_by)

    def get_backend(name):
        asked.append(name)
        if name == "partitioned":
            return cpu
        raise KeyError(name)

    monkeypatch.setattr(exec_backends, "get_backend", get_backend)
    t = Table({"k": np.array([1, 2, 1, 3]), "v": np.array([1, 2, 3, 4])})
    op = L.Aggregate(L.Scan("t"), ("k",), (("sum", "v", "s"),),
                     strategy="partial")
    with use_backend(VectorizedBackend()):
        out, _ = op._exec({"t": t}, {})
    assert asked == ["partitioned"] and used == ["partitioned"]
    assert out.column("s").tolist() == [4, 2, 4]


def test_partial_agg_is_a_noop_on_one_card(clients):
    jc, pc = clients
    assert passes._mesh_devices() == 1
    T = S.Schema.of("T", k="int64", v="int64")
    p = Pipeline("p")
    p.source("t", T)
    p.sql(name="agg", inputs={"t": "t"}, input_schemas={"t": T},
          output_schema=S.Schema.of("A", k="int64", s="int64"),
          group_keys=["k"], agg_specs=[("sum", "v", "s")],
          exprs=[col("k"), col("s")])
    pl = optimize(plan(p, table_stats={"t": TableStats(n_rows=10**7)}),
                  ("partial_agg",))
    assert "strategy=partial" not in pl.steps[0].logical.describe()
    assert not any("partial_agg" in n for n in pl.steps[0].provenance)


# ---------------------------------------------------------------------------
# partial aggregation over several cards (8 CPU "cards", in process)
# ---------------------------------------------------------------------------

def _eight_cards():
    return PartitionedBackend(device="cpu", devices=["cpu"] * 8)


@pytest.fixture
def eight_cards():
    """``partitioned`` registered over 8 CPU cards, as ``repro``'s forced
    8-device host mesh; the default factory is registered again after."""
    exec_backends.register("partitioned", _eight_cards)
    try:
        yield exec_backends.get_backend("partitioned")
    finally:
        exec_backends.register("partitioned",
                               exec_backends._partitioned_factory)


def test_register_again_replaces_a_built_instance(eight_cards):
    """``register`` drops the instance built from the earlier factory:
    the pass and ``Aggregate._exec`` then see the new one."""
    assert eight_cards.cards == 8 and passes._mesh_devices() == 8
    exec_backends.register(
        "partitioned",
        lambda: PartitionedBackend(device="cpu", devices=["cpu"] * 2))
    again = exec_backends.get_backend("partitioned")
    assert again is not eight_cards and again.cards == 2
    assert passes._mesh_devices() == 2


def _group_by_plan():
    """One GROUP BY over an int key, planned as if its source held
    400,000 rows (past the shard threshold)."""
    Src = S.Schema.of("Src", k=int, v=int)
    Agg = S.Schema.of("Agg", k=int, v_sum=int, v_min=int, v_max=int,
                      n=int, v_mean=float)
    p = Pipeline("gb")
    p.source("src", Src)
    p.sql(name="out", inputs={"s": "src"}, input_schemas={"s": Src},
          output_schema=Agg, group_keys=["k"],
          agg_specs=[("sum", "v"), ("min", "v"), ("max", "v"),
                     ("count", "v", "n"), ("mean", "v")])
    return plan(p, table_stats={"src": TableStats(n_rows=400_000,
                                                  key_kinds=("i",))})


def test_partial_agg_rewrites_over_eight_cards(eight_cards):
    """``repro``'s ``_PARTIAL_AGG_BODY`` (test_group_by_agg.py) on the
    port: the rewrite fires, moves the cache material, and the optimized
    plan's output fingerprints exactly as the unoptimized plan's."""
    pl = _group_by_plan()
    opt = optimize(pl)
    tree = opt.steps[0].logical
    assert "strategy=partial" in tree.describe(), tree.describe()
    assert any("partial_agg" in m for m in opt.steps[0].provenance)
    assert "devices=8" in " ".join(opt.steps[0].provenance)
    assert opt.steps[0].cache_material() != pl.steps[0].cache_material()

    r = np.random.default_rng(0)
    n = 400_000
    t = Table({"k": r.integers(0, 4096, n).astype(np.int32),
               "v": r.integers(-1000, 1000, n).astype(np.int32)})
    with use_backend(TorchAutoBackend(device="cpu")):
        a = pl.steps[0].execute({"src": t})
        b = opt.steps[0].execute({"src": t})
    assert a.fingerprint() == b.fingerprint()


def test_a_second_layout_misses_the_cache(eight_cards):
    """A rewritten step runs its aggregate on the registered
    ``partitioned`` backend, so its cache key carries that backend's
    layout: re-registered over another partition count, with the same
    cards (the same plan and provenance), the step runs again; a rerun
    on one layout is a hit."""
    opt = optimize(_group_by_plan())
    assert "strategy=partial" in opt.steps[0].logical.describe()
    r = np.random.default_rng(1)
    c = Client()
    c.write_source_table("main", "src", Table(
        {"k": r.integers(0, 64, 1000).astype(np.int64),
         "v": r.integers(-9, 9, 1000).astype(np.int64)}))
    with use_backend(TorchAutoBackend(device="cpu")):
        first = c.run(opt, "main")
        hit = c.run(opt, "main")
        exec_backends.register("partitioned", lambda: PartitionedBackend(
            device="cpu", devices=["cpu"] * 8, partitions=3))
        miss = c.run(opt, "main")
    assert first.executed == ("out",) and hit.cached == ("out",)
    assert miss.executed == ("out",), miss


ORDER_LINES = ("SELECT l_orderkey, SUM(l_quantity) AS qty, "
               "COUNT(l_quantity) AS n_lines, MIN(l_extendedprice) AS lo, "
               "MAX(l_extendedprice) AS hi, SUM(l_extendedprice) AS revenue "
               "FROM lineitem {where}GROUP BY l_orderkey")


@pytest.mark.parametrize("where", ["", "WHERE l_discount >= 0.05 "])
def test_partial_agg_query_matches_unoptimized(clients, low_thresholds,
                                               eight_cards, where):
    """``Client.sql`` with the default passes on 8 cards: Q18's
    ``order_lines`` GROUP BY runs as per-partition partials, and the
    result equals the unoptimized plan's and ``vectorized``'s (float
    SUM at rtol 1e-9)."""
    _, pc = clients
    query = ORDER_LINES.format(where=where)
    be = TorchAutoBackend(device="cpu")
    with tracing() as rec:
        fast = _port(pc, query, be, optimizer_passes=None)
    assert any("partial_agg" in n for n in fast.plan.steps[0].provenance)
    assert "strategy=partial" in fast.plan.steps[0].logical.describe()
    assert [s.attrs["cards"] for s in rec.spans("kernel")
            if s.attrs.get("op") == "partitioned.partial_agg"] == [8]
    slow = _port(pc, query, be, optimizer_passes=())
    assert_tables_equal(fast.table, slow.table)
    assert_tables_equal(fast.table, _port(pc, query).table)
