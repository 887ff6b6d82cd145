"""bfloat16 table columns in the port against ``repro``.

``repro`` holds a bfloat16 column as an ``ml_dtypes`` array; the port
holds its raw bits under :data:`repro_torch.data.bfloat16.BFLOAT16` and
computes each operation as ``ml_dtypes`` does. Every comparison here is
bit for bit, dtypes included, on the same numpy inputs: blobs and their
keys, fingerprints, ``to_pydict``, filters, arithmetic, joins, and the
five aggregates on ``reference`` and ``vectorized``, each port backend
held against ``repro``'s backend of the same name (both round a bfloat16
SUM at every step, in row order; ``vectorized`` adds +0.0 for a NULL).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.core.store import MemoryStore as JStore  # noqa: E402
from repro.data.tables import Table as JTable  # noqa: E402
from repro.data.tables import _ColumnData as JColumn  # noqa: E402
from repro.data.tables import arrow_cast as jcast, col as jcol  # noqa: E402

from repro_torch.core.store import MemoryStore  # noqa: E402
from repro_torch.data import bfloat16  # noqa: E402
from repro_torch.data.tables import Table, _ColumnData  # noqa: E402
from repro_torch.data.tables import arrow_cast, col  # noqa: E402
from repro_torch.exec.partitioned import PartitionedBackend  # noqa: E402
from repro_torch.exec.torch_auto import TorchAutoBackend  # noqa: E402
from repro_torch.exec.torch_backend import TorchBackend  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402

BF = ml_dtypes.bfloat16

# a small table: group 1's MIN is its one zero, -0.0
G = np.array([0, 1, 0, 1, 0, 1])
X = np.array([1.5, 2.25, 3, -0.0, 7, 1e-3], dtype=np.float32)


def _values(n: int = 600, seed: int = 0) -> np.ndarray:
    """float32 values over six decades, with +0.0 and -0.0 tied in the
    same groups, NaNs, and infinities."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 1e3], n)
         ).astype(np.float32)
    x[::11] = 0.0
    x[3::13] = -0.0
    x[7::97] = np.nan
    x[5::151] = np.inf
    return x


def _tables(n: int = 600, seed: int = 0, groups: int = 17):
    """The same table in both packages: int64 key ``g``, a nullable
    bfloat16 ``x``, an int8 ``y``; group 0 is all-NULL in ``x``."""
    rng = np.random.default_rng(seed + 1)
    g = rng.integers(0, groups, n)
    x = _values(n, seed).astype(BF)
    valid = (rng.random(n) > 0.15) & (g != 0)
    y = rng.integers(-100, 100, n).astype(np.int8)
    jt = JTable({"g": g, "y": y})
    jt._data["x"] = JColumn(x, valid.copy())
    pt = Table({"g": g, "y": y})
    pt._data["x"] = _ColumnData(bfloat16.from_bits(x.view(np.uint16)),
                                valid.copy())
    return pt, jt


def assert_same(got: Table, want: JTable):
    """Bit for bit: column names, dtypes, values, validity, fingerprint."""
    assert got.column_names() == want.column_names()
    for c in got.column_names():
        gv, wv = got.column(c), want.column(c)
        assert bfloat16.dtype_name(gv.dtype) == str(wv.dtype), c
        assert gv.tobytes() == wv.tobytes(), c
        gm, wm = got._data[c].valid, want._data[c].valid
        assert (gm is None) == (wm is None), c
        if gm is not None:
            assert gm.tolist() == wm.tolist(), c
    assert got.fingerprint() == want.fingerprint()


def test_rounding_and_ops_match_ml_dtypes():
    """The module's float32 -> bfloat16 rounding, over random bit
    patterns and the specials, and its add/minimum/maximum over random
    pairs, equal ``ml_dtypes``' bit for bit."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    specials = np.array([0, 0x80000000, 0x7F800000, 0xFF800000,
                         0x7F800001, 0xFFC00001, 0x7F7FFFFF, 0x3F808000,
                         0x3F818000, 0x3F80FFFF], dtype=np.uint32)
    f = np.concatenate([u, specials]).view(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        want = f.astype(BF).view(np.uint16)
    assert np.array_equal(bfloat16.bits(bfloat16.from_float32(f)), want)
    a = rng.integers(0, 2**16, 100_000).astype(np.uint16)
    b = rng.integers(0, 2**16, 100_000).astype(np.uint16)
    a[:6] = [0, 0x8000, 0x7FC0, 0x3F80, 0xFFC1, 0x7FC0]
    b[:6] = [0x8000, 0, 0x3F80, 0x7FC0, 0x7FC0, 0xFFC0]
    ja, jb = a.view(BF), b.view(BF)
    pa, pb = bfloat16.from_bits(a), bfloat16.from_bits(b)
    with np.errstate(invalid="ignore", over="ignore"):
        for ours, ufunc in ((bfloat16.add, np.add),
                            (bfloat16.minimum, np.minimum),
                            (bfloat16.maximum, np.maximum)):
            assert np.array_equal(ours(pa, pb),
                                  ufunc(ja, jb).view(np.uint16)), ufunc


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_blobs_round_trip_with_the_same_keys(writer):
    """A lake either package wrote loads in the other: the same blob
    keys, and the loaded table equals the written one bit for bit."""
    pt, jt = _tables()
    jstore, store = JStore(), MemoryStore()
    key = (jt.to_blobs(jstore) if writer == "repro"
           else pt.to_blobs(store))
    assert key == (pt.to_blobs(store) if writer == "repro"
                   else jt.to_blobs(jstore))
    assert sorted(jstore.keys()) == sorted(store.keys())
    for k in jstore.keys():
        assert store.get(k) == jstore.get(k)
    cols = store.get_json(key)["columns"]
    assert cols["x"]["dtype"] == "bfloat16"
    back = Table.from_blobs(store, key)
    assert_same(back, JTable.from_blobs(jstore, key))
    assert back.fingerprint() == jt.fingerprint()


def test_fingerprint_and_pydict():
    pt, jt = _tables()
    assert pt.fingerprint() == jt.fingerprint()
    got, want = pt.to_pydict(), jt.to_pydict()
    assert repr(got) == repr(want)
    small = Table({"x": bfloat16.from_float32(X)})
    assert small.to_pydict() == {
        "x": [1.5, 2.25, 3.0, -0.0, 7.0, 0.00099945068359375]}


def test_logical_dtype_raises_as_repro_does():
    pt, jt = _tables()
    with pytest.raises(TypeError) as want:
        jt.logical_dtype("x")
    with pytest.raises(TypeError) as got:
        pt.logical_dtype("x")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["reference", "vectorized"])
def test_filter(backend):
    pt, jt = _tables()
    assert_same(pt.filter(col("y") > 0, backend=backend),
                jt.filter(jcol("y") > 0, backend=backend))
    assert_same(pt.filter(col("x") > 0.5, backend=backend),
                jt.filter(jcol("x") > 0.5, backend=backend))


# each a case of its own; names stand for what they compute
_EXPRS = {
    "times_int_literal": lambda c, k: c("x") * 2,
    "times_float_literal": lambda c, k: c("x") * 1.5,
    "bf16_plus_bf16": lambda c, k: c("x") + c("x"),
    "bf16_times_int8": lambda c, k: c("x") * c("y"),
    "bf16_over_bf16": lambda c, k: c("x") / c("x"),
    "bf16_minus_int64": lambda c, k: c("x") - c("g"),
    "negate": lambda c, k: -c("x"),
    "compare": lambda c, k: c("x") >= c("y"),
    "equal_self": lambda c, k: c("x") == c("x"),
    "logical_not": lambda c, k: ~c("x"),
    "cast_int64": lambda c, k: k(c("x"), "Int64"),
    "cast_float32": lambda c, k: k(c("x"), "Float32"),
}


@pytest.mark.parametrize("name", sorted(_EXPRS))
def test_select_arithmetic(name):
    pt, jt = _tables()
    make = _EXPRS[name]
    with np.errstate(all="ignore"):
        want = jt.select([make(jcol, jcast).alias("r")])
        got = pt.select([make(col, arrow_cast).alias("r")])
    assert_same(got, want)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("backend", ["reference", "vectorized"])
def test_join_carries_a_bf16_payload(backend, how):
    """The probe side's ``x`` and the build side's ``z`` are bfloat16
    payloads; unmatched left rows get the canonical +0.0 fill."""
    pt, jt = _tables()
    z = _values(12, seed=5).astype(BF)
    jo = JTable({"g": np.arange(3, 15), "z": z})
    po = Table({"g": np.arange(3, 15),
                "z": bfloat16.from_bits(z.view(np.uint16))})
    assert_same(pt.join(po, on=["g"], how=how, backend=backend),
                jt.join(jo, on=["g"], how=how, backend=backend))
    assert_same(po.join(pt, on=["g"], how=how, backend=backend),
                jo.join(jt, on=["g"], how=how, backend=backend))


_DTYPES = {"sum": "bfloat16", "min": "bfloat16", "max": "bfloat16",
           "mean": "float64", "count": "int64"}


@pytest.mark.parametrize("fn", sorted(_DTYPES))
@pytest.mark.parametrize("backend", ["reference", "vectorized"])
@pytest.mark.parametrize("case", ["small_table", "random"])
def test_group_by_agg(case, backend, fn):
    """Each aggregate on each backend, held against ``repro``'s backend
    of the same name, with its output dtype."""
    if case == "small_table":
        jt = JTable({"g": G, "x": X.astype(BF)})
        pt = Table({"g": G, "x": bfloat16.from_float32(X)})
    else:
        pt, jt = _tables()
    with np.errstate(all="ignore"):
        want = jt.group_by(["g"]).agg((fn, "x"), backend=backend)
    got = pt.group_by(["g"]).agg((fn, "x"), backend=backend)
    assert bfloat16.dtype_name(got.column(f"x_{fn}").dtype) == _DTYPES[fn]
    assert_same(got, want)
    if case == "small_table":
        expect = {"sum": [11.5, 2.25], "min": [1.5, -0.0],
                  "max": [7.0, 2.25], "count": [3, 3]}.get(fn)
        if expect is not None:
            assert repr(got.to_pydict()[f"x_{fn}"]) == repr(expect)


def test_tied_zeros_and_nan_in_one_group():
    """MIN/MAX of tied ±0.0 keep the later row's zero, and a NaN
    poisons its group, on both backends, as in ``repro``."""
    x = np.array([0.0, -0.0, 1.0, -0.0, 0.0, np.nan, 2.0], np.float32)
    g = np.array([0, 0, 1, 1, 1, 2, 2])
    jt = JTable({"g": g, "x": x.astype(BF)})
    pt = Table({"g": g, "x": bfloat16.from_float32(x)})
    specs = [(f, "x") for f in ("min", "max", "sum")]
    for backend in ("reference", "vectorized"):
        with np.errstate(all="ignore"):
            want = jt.group_by(["g"]).agg(*specs, backend=backend)
        assert_same(pt.group_by(["g"]).agg(*specs, backend=backend), want)


def test_device_backends_route_bf16_to_the_host():
    """``torch_auto`` sends a bfloat16 value column to ``vectorized``
    by its dtype rule, at every size, and says so in an
    ``auto_decision`` event; ``torch`` and ``partitioned`` aggregate it
    on the host too. Each equals ``vectorized`` bit for bit."""
    pt, jt = _tables(n=200_000, groups=5000)
    specs = [(f, "x") for f in _DTYPES]
    with np.errstate(all="ignore"):
        want = jt.group_by(["g"]).agg(*specs, backend="vectorized")
    auto = TorchAutoBackend(device="cpu")
    with tracing() as rec:
        got = Table._from_cols(auto.group_by_agg(
            pt._to_cols(), ("g",),
            tuple((f, "x", f"x_{f}") for f in _DTYPES)))
    events = [e for e in rec.orphan_events()
              if e["name"] == "auto_decision"]
    assert [(e["op"], e["choice"]) for e in events] == [
        ("group_by_agg", "vectorized")]
    assert "bfloat16" in events[0]["reason"]
    assert_same(got, want)
    for be in (TorchBackend(device="cpu"), PartitionedBackend(device="cpu")):
        assert_same(pt.group_by(["g"]).agg(*specs, backend=be), want)


@pytest.mark.parametrize("backend", ["reference", "vectorized",
                                     "torch_auto"])
@pytest.mark.parametrize("op", ["group_by", "join"])
def test_bf16_key_columns_match_reference(op, backend):
    """A bfloat16 column as a key: grouped and self-joined as ``repro``'s
    ``reference`` does, bit for bit (``test_torch_bf16_keys.py`` holds
    every backend on more inputs)."""
    pt, jt = _tables(n=50)
    be = TorchAutoBackend(device="cpu") if backend == "torch_auto" \
        else backend
    with np.errstate(all="ignore"):
        if op == "group_by":
            want = jt.group_by(["x"]).agg(("count", "g"),
                                          backend="reference")
            got = pt.group_by(["x"]).agg(("count", "g"), backend=be)
        else:
            want = jt.join(jt.select([jcol("x"), jcol("g").alias("h")]),
                           on=["x"], backend="reference")
            got = pt.join(pt.select([col("x"), col("g").alias("h")]),
                          on=["x"], backend=be)
    assert_same(got, want)


def test_repro_vectorized_splits_a_signed_zero_group():
    """R12: ``repro``'s ``vectorized`` and ``jax`` backends code bfloat16
    keys by their sorted ``ml_dtypes`` values, so the ±0.0 rows of eight
    split into two groups and the self-join gives 42 rows, where
    ``reference`` (and every port backend) gives one group and 14 rows.
    If ``repro`` is ever fixed, this test says so."""
    keys = np.array([1, 2, 1, -0.0, 0.0, np.nan, np.nan, -0.0],
                    dtype=np.float32)
    v = np.arange(8, dtype=np.int32)
    jt = JTable({"k": keys.astype(BF), "v": v})
    pt = Table({"k": bfloat16.from_float32(keys), "v": v})
    for backend in ("vectorized", "jax"):
        got = jt.group_by(["k"]).agg(("sum", "v"), backend=backend)
        assert got.column("v_sum").tolist() == [2, 1, 7, 5, 6, 7], backend
        assert len(jt.join(jt, on=["k"], backend=backend)) == 42, backend
    want = jt.group_by(["k"]).agg(("sum", "v"), backend="reference")
    assert want.column("v_sum").tolist() == [2, 1, 14, 5, 6]
    assert len(jt.join(jt, on=["k"], backend="reference")) == 14
    assert_same(pt.group_by(["k"]).agg(("sum", "v"), backend="vectorized"),
                want)
    assert len(pt.join(pt, on=["k"], backend="vectorized")) == 14


def test_sql_refuses_a_bf16_column_as_repro_does():
    """``Client.sql``'s catalog discovery maps no bfloat16 column in
    either package: both raise the same compile error."""
    from repro.core.runner import Client as JClient
    from repro.sql.errors import SqlCompileError as JSqlCompileError
    from repro_torch.core.runner import Client
    from repro_torch.sql.errors import SqlCompileError

    pt, jt = _tables(n=200)
    jc, pc = JClient(), Client()
    jc.write_source_table("main", "t", jt)
    pc.write_source_table("main", "t", pt)
    query = "SELECT g, x * 2 AS x2 FROM t WHERE y > 0"
    with pytest.raises(JSqlCompileError) as want:
        jc.sql(query, optimizer_passes=())
    with pytest.raises(SqlCompileError) as got:
        pc.sql(query, optimizer_passes=(), cache=False)
    assert str(got.value) == str(want.value)
