"""The port's slice end to end: the TPC-H pipeline through ``Client.run``.

The same pipeline (``repro_torch/examples/tpch.py``, built once against
each package's API) runs on the same ~6,000 generated lineitem rows
through ``repro``'s ``Client`` (the ``reference`` backend, and ``jax``
with the Pallas kernels in interpret mode) and through the port's
``Client`` with ``TorchBackend(device="cpu")``. Published tables agree:
integers, strings, dates, counts and MIN/MAX bit for bit; float64
SUM/MEAN at rtol 1e-9, the summation-order carve-out. (With x64 off,
``jax`` routes the slice's 64-bit columns to numpy; the Pallas kernels
themselves are held against the port in ``test_torch_segment_sum.py``
and ``test_torch_backend.py``.)

Also here: the port's transactions (one commit per run; an aborted run
leaves ``main`` as it was) and a lake that ``repro`` wrote, opened by
the port through ``repro_torch.convert``.
"""
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.exec as jexec  # noqa: E402
from repro.core import schema as JS  # noqa: E402
from repro.core.catalog import Catalog as JCatalog  # noqa: E402
from repro.core.dag import Pipeline as JPipeline  # noqa: E402
from repro.core.planner import plan as jplan  # noqa: E402
from repro.core.runner import Client as JClient  # noqa: E402
from repro.core.store import FileStore as JFileStore  # noqa: E402
from repro.data.tables import Table as JTable  # noqa: E402
from repro.data.tables import col as jcol, lit as jlit  # noqa: E402
from repro.exec.jax_backend import JaxBackend  # noqa: E402

from repro_torch.convert import open_lake, tables_from_snapshots  # noqa: E402
from repro_torch.core.errors import TransactionAborted  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.core.runner import Client  # noqa: E402
from repro_torch.data.tables import Table  # noqa: E402
from repro_torch.examples import tpch  # noqa: E402
from repro_torch.exec import use_backend  # noqa: E402
from repro_torch.exec.torch_backend import TorchBackend  # noqa: E402
from repro_torch.kernels.segment_sum import ops  # noqa: E402

SF = 0.001                      # 6,001 lineitem rows, 1,500 orders
JAX_API = types.SimpleNamespace(S=JS, Pipeline=JPipeline, col=jcol,
                                lit=jlit)
CPU = TorchBackend(device="cpu")
FLOAT_AGGS = {"sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
              "avg_price", "avg_disc"}
# Q18's threshold keeps ~no order at this scale; a lower one gives the
# join and filter rows to emit (the same pipeline for both packages).
QUANTITY = 150


@pytest.fixture(scope="module")
def data():
    return tpch.generate(SF, seed=0)


@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(tpch, "Q18_QUANTITY", QUANTITY)


def _load(client, table_cls, data):
    for name, cols in data.items():
        client.write_source_table("main", name, table_cls(cols))
    return client


def run_repro(data, backend, monkeypatch, client=None):
    client = _load(client or JClient(), JTable, data)
    pl = jplan(tpch.build_pipeline(JAX_API))
    if isinstance(backend, str):
        with jexec.use_backend(backend):
            result = tpch.run_slice(client, pl)
    else:
        with monkeypatch.context() as m:
            m.setattr(jexec, "active_backend", lambda: backend)
            result = tpch.run_slice(client, pl)
    assert result.state.status == "committed"
    return client, {t: client.read_table("main", t) for t in result.tables}


def run_port(data, backend=CPU, client=None, **kw):
    client = _load(client or Client(), Table, data)
    with use_backend(backend):
        result = tpch.run_slice(client, plan(tpch.build_pipeline()), **kw)
    assert result.state.status == "committed"
    return client, {t: client.read_table("main", t) for t in result.tables}


def assert_published_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in got:
        a, b = got[name], want[name]
        assert a.column_names() == b.column_names(), name
        assert len(a) == len(b), name
        for c in a.column_names():
            assert a.validity(c).tolist() == b.validity(c).tolist(), c
            x, y = a.column(c), b.column(c)
            if c in FLOAT_AGGS:
                np.testing.assert_allclose(x, y, rtol=1e-9, atol=0,
                                           err_msg=f"{name}.{c}")
            elif x.dtype == object:
                assert x.tolist() == y.tolist(), (name, c)
            else:
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (
                    name, c)


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------

def test_generated_data_has_tpch_shape(data):
    li, orders = data["lineitem"], data["orders"]
    assert len(li["l_orderkey"]) == round(tpch.LINEITEM_ROWS_SF1 * SF)
    assert len(orders["o_orderkey"]) == round(tpch.ORDERS_ROWS_SF1 * SF)
    assert li["l_quantity"].dtype == np.int64
    assert set(li["l_quantity"]) <= set(range(1, 51))
    assert set(li["l_returnflag"]) == {"A", "N", "R"}
    assert set(li["l_linestatus"]) == {"O", "F"}
    assert li["l_discount"].min() >= 0 and li["l_discount"].max() <= 0.10
    assert li["l_tax"].min() >= 0 and li["l_tax"].max() <= 0.08
    assert set(li["l_orderkey"]) == set(orders["o_orderkey"])


def test_generation_is_seeded():
    a, b = tpch.generate(SF, seed=3), tpch.generate(SF, seed=3)
    for t in a:
        for c in a[t]:
            assert np.array_equal(a[t][c], b[t][c]), (t, c)


@pytest.mark.parametrize("oracle", ["reference", "jax-pallas"])
def test_slice_matches_repro(data, oracle, monkeypatch, low_threshold):
    backend = ("reference" if oracle == "reference"
               else JaxBackend(use_pallas=True, interpret=True))
    _, want = run_repro(data, backend, monkeypatch)
    _, got = run_port(data)
    assert_published_equal(got, want)
    assert len(got["large_orders"]) > 0
    assert len(got["pricing_summary"]) == 4


def test_integer_and_minmax_tables_fingerprint_like_reference(
        data, monkeypatch, low_threshold):
    """No float sum in these two: the port's fingerprints are
    ``repro``'s, byte for byte."""
    _, want = run_repro(data, "reference", monkeypatch)
    _, got = run_port(data)
    for t in ("order_lines", "large_orders"):
        assert got[t].fingerprint() == want[t].fingerprint(), t


@pytest.mark.parametrize("backend", ["vectorized", "reference"])
def test_torch_backend_matches_port_host_backends(data, backend,
                                                  low_threshold):
    _, want = run_port(data, backend)
    _, got = run_port(data)
    assert_published_equal(got, want)


def test_rerun_without_cache_reproduces_fingerprints(data):
    _, a = run_port(data)
    _, b = run_port(data, cache=False)
    assert ({t: a[t].fingerprint() for t in a}
            == {t: b[t].fingerprint() for t in b})


def test_cpu_run_counts_no_launches(data):
    before = (ops.masked_segment_sum.launches,
              ops.masked_segment_reduce.launches)
    run_port(data)
    assert (ops.masked_segment_sum.launches,
            ops.masked_segment_reduce.launches) == before


# ---------------------------------------------------------------------------
# transactions in the port
# ---------------------------------------------------------------------------

def test_one_commit_per_run(data):
    client = _load(Client(), Table, data)
    start = client.catalog.head("main").id
    client.create_branch("tpch", from_ref="main")
    with use_backend(CPU):
        result = client.run(plan(tpch.build_pipeline()), "tpch")
    log = client.catalog.log("tpch")
    assert log[1].id == start                  # exactly one new commit
    assert set(log[0].tables) >= {"pricing_summary", "order_lines",
                                  "large_orders"}
    assert set(result.tables) == {"pricing_summary", "order_lines",
                                  "large_orders"}


def test_failed_run_leaves_main_unchanged(data):
    client = _load(Client(), Table, data)
    before = client.catalog.head("main").id
    with use_backend(CPU), pytest.raises(TransactionAborted):
        client.run(plan(tpch.build_pipeline()), "main",
                   fail_after="order_lines")
    assert client.catalog.head("main").id == before
    assert "order_lines" not in client.catalog.tables("main")


# ---------------------------------------------------------------------------
# a lake that repro wrote, carried across
# ---------------------------------------------------------------------------

def test_lake_written_by_repro_opens_in_the_port(data, tmp_path,
                                                 monkeypatch,
                                                 low_threshold):
    jclient = JClient(JCatalog(JFileStore(str(tmp_path))))
    _, published = run_repro(data, "reference", monkeypatch, jclient)
    snaps = jclient.catalog.tables("main")

    catalog = open_lake(str(tmp_path), snaps)
    tables = tables_from_snapshots(catalog.store, snaps)
    for name, snap in snaps.items():
        assert (tables[name].fingerprint()
                == JTable.from_blobs(jclient.store, snap).fingerprint()), name

    # the port's run over the carried sources publishes the same tables
    client = Client(catalog)
    client.create_branch("port", from_ref="main")
    with use_backend(CPU):
        result = client.run(plan(tpch.build_pipeline()), "port")
    got = {t: Table.from_blobs(client.store, s)
           for t, s in result.tables.items()}
    assert_published_equal(got, published)


def test_open_lake_refuses_what_is_not_a_table(tmp_path):
    store = JFileStore(str(tmp_path))
    key = store.put_json({"kind": "pytree"})
    with pytest.raises(ValueError):
        open_lake(str(tmp_path), {"t": key})
    with pytest.raises(KeyError):
        open_lake(str(tmp_path), {"t": "0" * 64})
