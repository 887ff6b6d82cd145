"""bfloat16 key columns on every port backend, against ``repro``'s
``reference``.

``repro``'s ``reference`` compares ``ml_dtypes`` bfloat16 keys as their
values compare: ``±0.0`` are one key (a group shows its first row's
zero), a NaN key, quiet or with a payload, matches nothing and is a
group of its own, and a NULL key matches nothing and joins the one NULL
group. Every port backend is held to it bit for bit: values, NULL
masks, key bits and row order. Inputs are drawn from a numpy seed over
a pool of key bit patterns with many duplicates: both zeros, quiet NaNs
of either sign, NaNs with payload bits, infinity and ordinary values,
alone and beside an int key, with NULL lanes; joins inner, left and
masked (the filter fused into the probe, as ``probe_fusion`` runs it),
with empty sides. ``repro``'s own ``vectorized`` is not an oracle here
(ROADMAP R8, R12). The last case runs ``examples/bf16_keys.py``'s
pipeline through ``Client.run`` in both packages.
"""
import types

import numpy as np
import pytest

pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.core import schema as JS  # noqa: E402
from repro.core.dag import Pipeline as JPipeline  # noqa: E402
from repro.core.runner import Client as JClient  # noqa: E402
from repro.data.tables import Table as JTable  # noqa: E402
from repro.data.tables import col as jcol, lit as jlit  # noqa: E402
from repro.exec import use_backend as juse_backend  # noqa: E402
from repro.exec.stats import collect_stats as jcollect_stats  # noqa: E402

from repro_torch.core.planner import plan  # noqa: E402
from repro_torch.data import bfloat16  # noqa: E402
from repro_torch.data.tables import Table, col  # noqa: E402
from repro_torch.examples import bf16_keys  # noqa: E402
from repro_torch.examples.tpch import generate  # noqa: E402
from repro_torch.exec import torch_auto, use_backend  # noqa: E402
from repro_torch.exec.partitioned import PartitionedBackend  # noqa: E402
from repro_torch.exec.stats import collect_stats  # noqa: E402
from repro_torch.exec.torch_auto import TorchAutoBackend  # noqa: E402
from repro_torch.exec.torch_backend import TorchBackend  # noqa: E402

BF = ml_dtypes.bfloat16

# +0.0, -0.0, quiet NaN, -quiet NaN, NaNs with payload bits (one with
# the quiet bit clear), +inf, 1.0, 2.0, -1.5, 3.0
POOL = np.array([0x0000, 0x8000, 0x7FC0, 0xFFC0, 0x7FC1, 0x7F81, 0x7F80,
                 0x3F80, 0x4000, 0xBFC0, 0x4040], dtype=np.uint16)

BACKENDS = {
    "reference": lambda: "reference",
    "vectorized": lambda: "vectorized",
    "torch_cpu": lambda: TorchBackend(device="cpu"),
    "partitioned_1": lambda: PartitionedBackend(devices=["cpu"]),
    "partitioned_2": lambda: PartitionedBackend(devices=["cpu"] * 2),
    "partitioned_8": lambda: PartitionedBackend(devices=["cpu"] * 8),
    "torch_auto": lambda: TorchAutoBackend(device="cpu"),
    # thresholds lowered: the join takes partitioned's probe and the
    # group-by the torch backend's segment path, as at full size
    "torch_auto_device_rows": lambda: TorchAutoBackend(device="cpu"),
}


@pytest.fixture(params=sorted(BACKENDS))
def backend(request, monkeypatch):
    if request.param == "torch_auto_device_rows":
        monkeypatch.setattr(torch_auto, "TINY_ROWS", 0)
        monkeypatch.setattr(torch_auto, "SHARD_ROWS", 1)
        monkeypatch.setattr(torch_auto, "DEVICE_ROWS", 1)
    return BACKENDS[request.param]()


def _key_bits(rng, n: int, zero_first: "str | None" = None) -> np.ndarray:
    p = np.array([4, 4, 2, 1, 1, 1, 1, 3, 3, 2, 2], dtype=float)
    bits = rng.choice(POOL, size=n, p=p / p.sum())
    if zero_first is not None and n >= 2:
        bits[:2] = (0x0000, 0x8000) if zero_first == "+0" else (0x8000,
                                                                 0x0000)
    return bits


def tables(n: int, seed: int, *, nulls: bool = True,
           zero_first: "str | None" = None):
    """The same table in both packages: a bfloat16 key ``k`` (NULL in
    about one row in eight when ``nulls``), an int64 key ``j``, an int32
    ``v``, a float32 ``x`` and an int64 ``y``."""
    rng = np.random.default_rng(seed)
    bits = _key_bits(rng, n, zero_first)
    valid = rng.random(n) > 0.125 if nulls else None
    j = rng.integers(0, 3, n).astype(np.int64)
    v = rng.integers(-50, 50, n).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.integers(-9, 10, n).astype(np.int64)
    port = Table._from_cols({
        "k": (bfloat16.from_bits(bits), None if valid is None
              else valid.copy()),
        "j": (j, None), "v": (v, None), "x": (x, None), "y": (y, None)})
    jax_side = JTable._from_cols({
        "k": (bits.copy().view(BF), None if valid is None
              else valid.copy()),
        "j": (j, None), "v": (v, None), "x": (x, None), "y": (y, None)})
    return port, jax_side


def assert_same(got: Table, want: JTable):
    """Bit for bit: names, dtypes, values (key bits), validity, row
    order, fingerprint."""
    assert got.column_names() == want.column_names()
    for c in got.column_names():
        gv, wv = got.column(c), want.column(c)
        assert bfloat16.dtype_name(gv.dtype) == str(wv.dtype), c
        assert gv.tobytes() == wv.tobytes(), c
        assert got.validity(c).tolist() == want.validity(c).tolist(), c
    assert got.fingerprint() == want.fingerprint()


SPECS = (("count", "v"), ("sum", "v"), ("min", "x"), ("max", "x"),
         ("sum", "y"))


@pytest.mark.parametrize("keys", [["k"], ["k", "j"], ["j", "k"]])
def test_group_by(backend, keys):
    pt, jt = tables(300, 1)
    want = jt.group_by(keys).agg(*SPECS, backend="reference")
    assert_same(pt.group_by(keys).agg(*SPECS, backend=backend), want)


@pytest.mark.parametrize("zero_first", ["+0", "-0"])
def test_group_key_is_the_first_rows_zero(backend, zero_first):
    pt, jt = tables(120, 2, nulls=False, zero_first=zero_first)
    want = jt.group_by(["k"]).agg(("count", "v"), backend="reference")
    got = pt.group_by(["k"]).agg(("count", "v"), backend=backend)
    assert_same(got, want)
    zeros = bfloat16.widen(got.column("k")) == 0
    assert zeros.sum() == 1
    assert bfloat16.bits(got.column("k"))[zeros][0] == (
        0x0000 if zero_first == "+0" else 0x8000)


@pytest.mark.parametrize("on", [["k"], ["k", "j"]])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join(backend, how, on):
    pl, jl = tables(160, 3)
    pr, jr = tables(90, 4)
    pr = pr.select([col(c).alias(c if c in on else f"r_{c}")
                    for c in pr.column_names()])
    jr = jr.select([jcol(c).alias(c if c in on else f"r_{c}")
                    for c in jr.column_names()])
    assert_same(pl.join(pr, on=on, how=how, backend=backend),
                jl.join(jr, on=on, how=how, backend="reference"))


@pytest.mark.parametrize("side,how", [("left", "inner"),
                                      ("right", "inner"),
                                      ("right", "left")])
def test_masked_join(backend, side, how):
    """A filter fused into the probe: a masked left join prefilters, a
    masked probe side drops its rows inside the probe."""
    pl, jl = tables(200, 5)
    pr, jr = tables(60, 6)
    pr = pr.select([col("k"), col("y").alias("ry"), col("v").alias("rv")])
    jr = jr.select([jcol("k"), jcol("y").alias("ry"), jcol("v").alias("rv")])
    preds = {"left": (col("y") > 0, jcol("y") > 0),
             "right": (col("ry") < 3, jcol("ry") < 3)}
    pp, jp = preds[side]
    kw = "left_pred" if side == "left" else "right_pred"
    want = jl.masked_join(jr, on=["k"], how=how, backend="reference",
                          **{kw: jp})
    got = pl.masked_join(pr, on=["k"], how=how, backend=backend, **{kw: pp})
    assert_same(got, want)


@pytest.mark.parametrize("empty", ["left", "right", "both"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_with_an_empty_side(backend, empty, how):
    pl, jl = tables(0 if empty in ("left", "both") else 50, 7)
    pr, jr = tables(0 if empty in ("right", "both") else 40, 8)
    pr = pr.select([col("k"), col("v").alias("rv")])
    jr = jr.select([jcol("k"), jcol("v").alias("rv")])
    assert_same(pl.join(pr, on=["k"], how=how, backend=backend),
                jl.join(jr, on=["k"], how=how, backend="reference"))


def test_self_join_counts_as_reference(backend):
    """Eight rows: ±0.0 one group, its key the first row's
    -0.0; NaNs their own groups and unmatched; 14 self-join rows."""
    keys = np.array([1, 2, 1, -0.0, 0.0, np.nan, np.nan, -0.0], np.float32)
    v = np.arange(8, dtype=np.int32)
    pt = Table({"k": bfloat16.from_float32(keys), "v": v})
    jt = JTable({"k": keys.astype(BF), "v": v})
    want = jt.group_by(["k"]).agg(("sum", "v"), backend="reference")
    got = pt.group_by(["k"]).agg(("sum", "v"), backend=backend)
    assert_same(got, want)
    assert got.column("v_sum").tolist() == [2, 1, 14, 5, 6]
    assert bfloat16.bits(got.column("k")).tolist()[2] == 0x8000
    assert len(pt.join(pt, on=["k"], backend=backend)) == 14
    assert_same(pt.join(pt, on=["k"], backend=backend),
                jt.join(jt, on=["k"], backend="reference"))


def test_stats_count_a_bf16_key_as_its_float32_form():
    """Plan-time statistics count a bfloat16 key's distinct values as
    ``repro`` counts the same key cast to float32 (``±0.0`` one value,
    NaNs one); its kind stays ``V``, as ``ml_dtypes``' is."""
    pt, jt = tables(500, 9, nulls=False)
    got = collect_stats(pt._to_cols(), ["k"])
    assert got.key_kinds == jcollect_stats(jt._to_cols(), ["k"]).key_kinds
    as_f32 = JTable({"k": jt.column("k").astype(np.float32)})
    assert got.est_key_cardinality == jcollect_stats(
        as_f32._to_cols(), ["k"]).est_key_cardinality


JAX_API = types.SimpleNamespace(
    S=JS, Pipeline=JPipeline, col=jcol, lit=jlit, Client=JClient,
    Table=JTable, to_key=lambda a: a.astype(BF),
    from_key=lambda a: a.astype(np.float32))


@pytest.fixture(scope="module")
def pipeline_reference():
    """``examples/bf16_keys.py``'s lineitem at SF 0.002 and ``repro``'s
    tables of its pipeline on ``reference``."""
    lineitem = bf16_keys.lineitem_for_keys(generate(0.002, 0)["lineitem"])
    from repro.core.planner import plan as jplan
    client = bf16_keys.fresh_client(lineitem, JAX_API)
    with juse_backend("reference"):
        result, tables_ = bf16_keys.run(
            client, jplan(bf16_keys.build_pipeline(JAX_API)))
    assert result.state.status == "committed"
    return lineitem, tables_


@pytest.mark.parametrize("name", ["reference", "vectorized", "torch_auto",
                                  "torch_auto_device_rows"])
def test_client_run_matches_repro(pipeline_reference, monkeypatch, name):
    """The three nodes through ``Client.run`` on a branch, one commit,
    against ``repro``'s run of the same pipeline on ``reference``."""
    lineitem, want = pipeline_reference
    if name == "torch_auto_device_rows":
        monkeypatch.setattr(torch_auto, "SHARD_ROWS", 1)
        monkeypatch.setattr(torch_auto, "DEVICE_ROWS", 1)
    be = (TorchAutoBackend(device="cpu") if name.startswith("torch_auto")
          else name)
    client = bf16_keys.fresh_client(lineitem)
    with use_backend(be):
        result, got = bf16_keys.run(client, plan(bf16_keys.build_pipeline()))
    assert result.state.status == "committed"
    commits = [c for c in client.catalog.log("main", limit=10)
               if c.run_id == result.state.run_id]
    assert len(commits) == 1 and set(bf16_keys.TABLES) <= set(
        commits[0].tables)
    for t in bf16_keys.TABLES:
        assert_same(got[t], want[t])
    checked = bf16_keys.check_keys(got, lineitem)
    assert checked["nan_lanes"] > 0 and checked["neg_zero_lanes"] > 0
