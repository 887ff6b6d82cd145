"""The port's ``torch_auto`` policy and its statistics.

The decision table is a pure function of :class:`TableStats`: each row,
its reason string and the cache token are pinned here. The backend is
built on the CPU (``TorchAutoBackend(device="cpu")``), where every
delegate runs on the CPU; routed joins and group-bys are held against
``repro``'s ``reference`` backend (integers exact, float SUM at rtol
1e-9, the summation-order carve-out). ``repro_torch.exec.stats`` is
held against ``repro.exec.stats`` on the differential fixture.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.exec import stats as jstats  # noqa: E402
from repro.exec.reference import ReferenceBackend  # noqa: E402
from test_exec_backends import random_table  # noqa: E402

from repro_torch import exec as exec_backends  # noqa: E402
from repro_torch.core import schema as S  # noqa: E402
from repro_torch.core.dag import Pipeline  # noqa: E402
from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.exec import BackendUnavailable  # noqa: E402
from repro_torch.exec import torch_auto  # noqa: E402
from repro_torch.exec.partitioned import PartitionedBackend  # noqa: E402
from repro_torch.exec.stats import TableStats, collect_stats  # noqa: E402
from repro_torch.exec.torch_auto import (  # noqa: E402
    TorchAutoBackend, choose_group_by_agg, choose_join,
    explain_group_by_agg, explain_join)
from repro_torch.obs import tracing  # noqa: E402

REF = ReferenceBackend()
I64, F64, OBJ = np.dtype(np.int64), np.dtype(np.float64), np.dtype(object)


def _st(n, **kw):
    return TableStats(n_rows=n, **kw)


# ---------------------------------------------------------------------------
# the decision table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nl,nr,want,why", [
    (10, 54, "reference", "total rows 64 <= tiny threshold 64"),
    (30, 35, "vectorized", "default row (no specialized row matched)"),
    (150_000, 49_999, "vectorized",
     "default row (no specialized row matched)"),
    (150_000, 50_000, "partitioned",
     "total rows 200000 >= shard threshold 200000 (hash probe kernels "
     "on the card)"),
    (6_001_215, 1_500_000, "partitioned",
     "total rows 7501215 >= shard threshold 200000 (hash probe kernels "
     "on the card)"),
])
def test_join_rows(nl, nr, want, why):
    assert explain_join(_st(nl), _st(nr)) == (want, why)
    assert choose_join(_st(nl), _st(nr)) == want


def test_dense_int_key_joins_go_to_the_card():
    """The reference's dense single-int-key row (-> vectorized) is left
    out: on the card the probe kernel is the direct-address table."""
    dense = dict(key_kinds=("i",), int_key_lo=0, int_key_hi=1000,
                 int_key_span=1001)
    assert choose_join(_st(500_000, **dense),
                       _st(500_000, **dense)) == "partitioned"
    assert choose_join(_st(1_000, **dense),
                       _st(1_000, **dense)) == "vectorized"


@pytest.mark.parametrize("n,dtypes,want,why", [
    (64, (F64,), "reference", "rows 64 <= tiny threshold 64"),
    (65, (F64,), "vectorized", "default row (no specialized row matched)"),
    (99_999, (I64, F64), "vectorized",
     "default row (no specialized row matched)"),
    (100_000, (I64, F64), "torch",
     "rows 100000 >= device threshold 100000 with device-lowerable "
     "values (segment-reduce kernels)"),
    (100_000, (I64, OBJ), "vectorized",
     "value dtype(s) not device-lowerable"),
    (5_000_000, (np.dtype(np.uint32),), "vectorized",
     "value dtype(s) not device-lowerable"),
])
def test_group_by_agg_rows(n, dtypes, want, why):
    assert explain_group_by_agg(_st(n), dtypes) == (want, why)
    assert choose_group_by_agg(_st(n), dtypes) == want


@pytest.mark.parametrize("cards", [2, 8])
def test_group_by_agg_partitioned_row(cards):
    dense = dict(key_kinds=("i",), int_key_lo=0, int_key_hi=1_500_000,
                 int_key_span=1_500_001)
    st = _st(6_001_215, **dense)
    assert explain_group_by_agg(st, (I64, F64), cards=cards) == (
        "partitioned",
        f"rows 6001215 >= shard threshold 200000 on {cards} cards with "
        f"dense single int key and device-lowerable values "
        f"(per-partition partials)")
    # one card, a sparse key, two keys or a host-only value: the old rows
    assert choose_group_by_agg(st, (I64, F64)) == "torch"
    sparse = dataclasses.replace(st, int_key_hi=10**12)
    assert choose_group_by_agg(sparse, (I64,), cards=cards) == "torch"
    two = dataclasses.replace(st, key_kinds=("i", "i"))
    assert choose_group_by_agg(two, (I64,), cards=cards) == "torch"
    assert choose_group_by_agg(st, (OBJ,), cards=cards) == "vectorized"
    assert choose_group_by_agg(_st(199_999, **dense), (I64,),
                               cards=cards) == "torch"


# repro's decision table, with its names mapped to the port's; both
# sides lower these value dtypes (repro lowers int64/float64 only under
# jax_enable_x64, the port always: the north star's int64 rule)
_PORT_NAME = {"sharded": "partitioned", "jax": "torch"}
_GRID_DTYPES = [(np.dtype(np.int32),), (np.dtype(np.float32),),
                (np.dtype(np.int8), np.dtype(np.float32)),
                (np.dtype(np.uint8),), (OBJ,), (np.dtype(np.int32), OBJ)]


def _grid():
    for n in (64, 65, 99_999, 100_000, 199_999, 200_000, 6_001_215):
        for kinds in ((), ("i",), ("u",), ("f",), ("i", "i")):
            for bounds in (None, (0, n), (-5, 4 * n + 1018),
                           (-5, 4 * n + 1019), (0, 10**12)):
                kw = dict(key_kinds=kinds)
                if bounds is not None and kinds in (("i",), ("u",)):
                    lo, hi = bounds
                    kw.update(int_key_lo=lo, int_key_hi=hi,
                              int_key_span=hi - lo + 1)
                yield _st(n, **kw)


@pytest.mark.parametrize("cards", [1, 8])
@pytest.mark.parametrize("dtypes", _GRID_DTYPES, ids=str)
def test_group_by_agg_table_matches_repro(cards, dtypes):
    from repro.exec import auto as jauto
    for st in _grid():
        jst = jstats.TableStats(**dataclasses.asdict(st))
        want = jauto.choose_group_by_agg(
            jst, dtypes, n_devices=cards, sharded_available=True,
            jax_available=True)
        got = choose_group_by_agg(st, dtypes, cards=cards)
        assert got == _PORT_NAME.get(want, want), (st, dtypes)


# ---------------------------------------------------------------------------
# the backend on the CPU
# ---------------------------------------------------------------------------

CPU = TorchAutoBackend(device="cpu")


def test_cache_token_is_pinned():
    assert CPU.cache_token() == (
        "torch_auto[v2;tiny=64;shard=200000;device_rows=100000;"
        "torch[cpu],partitioned[cpu;partitions=1]]")


def test_delegates_are_built_on_its_device():
    assert CPU.device == torch.device("cpu")
    for name in ("torch", "partitioned"):
        assert CPU.delegate(name).device == torch.device("cpu")
    assert {CPU.delegate(n).name for n in
            ("reference", "vectorized", "torch", "partitioned")} == {
        "reference", "vectorized", "torch", "partitioned"}


def _events(rec):
    return [e for e in rec.orphan_events() if e["name"] == "auto_decision"]


@pytest.mark.parametrize("shard_rows,want", [(10**9, "vectorized"),
                                             (100, "partitioned")])
def test_join_routes_and_matches_reference(monkeypatch, shard_rows, want):
    monkeypatch.setattr(torch_auto, "SHARD_ROWS", shard_rows)
    left = random_table(300, 1)._to_cols()
    right = random_table(120, 2)._to_cols()
    with tracing() as rec:
        got = CPU.hash_join(left, right, ["ki"], "inner")
        got_m = CPU.masked_hash_join(
            left, right, ["ki"], "inner",
            left_mask=np.arange(300) % 3 != 0)
    assert [(e["op"], e["choice"]) for e in _events(rec)] == [
        ("hash_join", want), ("masked_hash_join", want)]
    for a, b in ((got, REF.hash_join(left, right, ["ki"], "inner")),
                 (got_m, REF.masked_hash_join(
                     left, right, ["ki"], "inner",
                     left_mask=np.arange(300) % 3 != 0))):
        assert list(a) == list(b)
        for c in a:
            assert [repr(x) for x in a[c][0]] == [repr(x) for x in b[c][0]]


@pytest.mark.parametrize("device_rows,want", [(10**9, "vectorized"),
                                              (100, "torch")])
def test_group_by_routes_and_matches_reference(monkeypatch, device_rows,
                                               want):
    monkeypatch.setattr(torch_auto, "DEVICE_ROWS", device_rows)
    cols = random_table(400, 3)._to_cols()
    specs = (("sum", "f", "s"), ("min", "v32", "lo"), ("count", "f", "n"))
    with tracing() as rec:
        got = CPU.group_by_agg(cols, ["ki"], specs)
    assert [e["choice"] for e in _events(rec)] == [want]
    ref = REF.group_by_agg(cols, ["ki"], specs)
    assert list(got) == list(ref)
    for c in ("ki", "lo", "n"):
        assert got[c][0].tobytes() == ref[c][0].tobytes()
    ok = ref["s"][1]
    np.testing.assert_allclose(got["s"][0][ok], ref["s"][0][ok], rtol=1e-9)


def test_group_by_routes_to_partitioned_over_several_cards(monkeypatch):
    """With the partitioned delegate over 4 cards, a large dense-key
    GROUP BY takes the partitioned row and matches reference."""
    monkeypatch.setattr(torch_auto, "SHARD_ROWS", 100)
    auto = TorchAutoBackend(device="cpu")
    monkeypatch.setitem(auto._delegates, "partitioned", PartitionedBackend(
        device="cpu", devices=["cpu"] * 4))
    cols = random_table(400, 4)._to_cols()
    specs = (("sum", "v32", "s"), ("min", "f", "lo"), ("count", "f", "n"))
    with tracing() as rec:
        got = auto.group_by_agg(cols, ["ki"], specs)
    assert [e["choice"] for e in _events(rec)] == ["partitioned"]
    assert [s.attrs["cards"] for s in rec.spans("kernel")
            if s.attrs.get("op") == "partitioned.partial_agg"] == [4]
    ref = REF.group_by_agg(cols, ["ki"], specs)
    assert list(got) == list(ref)
    for c in got:
        assert got[c][0].tobytes() == ref[c][0].tobytes(), c


def test_planner_stats_skip_collection(monkeypatch):
    """Stats passed by the planner are used as given, not re-collected."""
    def boom(*a, **k):
        raise AssertionError("collected stats the caller passed")

    monkeypatch.setattr(torch_auto, "collect_stats", boom)
    left = random_table(50, 1)._to_cols()
    out = CPU.hash_join(left, left, ["ki"], "inner",
                        left_stats=_st(50), right_stats=_st(50))
    assert len(next(iter(out.values()))[0]) > 0


def test_default_backend_is_torch_auto_on_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(exec_backends, "_active", None)
    monkeypatch.delenv("REPRO_TORCH_EXEC_BACKEND", raising=False)
    assert exec_backends.DEFAULT_BACKEND == "torch_auto"
    if torch.cuda.is_available():
        assert exec_backends.active_backend().name == "torch_auto"
        return
    with pytest.raises(BackendUnavailable,
                       match=r'TorchAutoBackend\(device="cpu"\)'):
        exec_backends.active_backend()


# ---------------------------------------------------------------------------
# repro_torch.exec.stats (the planner documents it as its stats type)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", [["ki"], ["ks"], ["f"], ["ki", "ks"]],
                         ids="+".join)
@pytest.mark.parametrize("n", [0, 37, 5000])
def test_collect_stats_matches_repro(keys, n):
    t = random_table(n, 11)._to_cols()
    got = collect_stats(t, keys)
    want = jstats.collect_stats(t, keys)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.single_int_key == want.single_int_key


def test_planner_records_table_stats():
    T = S.Schema.of("T", k="int64")
    p = Pipeline("p")
    p.source("t", T)
    p.sql(name="out", inputs={"t": "t"}, input_schemas={"t": T},
          output_schema=T)
    pl = plan(p, table_stats={"t": TableStats(n_rows=123)})
    assert pl.steps[0].input_stats == {"t": TableStats(n_rows=123)}
    assert "t rows=123" in pl.describe()
