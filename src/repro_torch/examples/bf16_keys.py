"""bfloat16 key columns at TPC-H scale: a GROUP BY and two joins.

``lineitem`` (``examples/tpch.py``'s, 6,001,215 rows at SF1, its numeric
columns) has one ``l_discount`` lane in :data:`NEG_ZERO_EVERY` set to
-0.0 and one in :data:`NAN_EVERY` to NaN. ``discount_band`` holds the 11
distinct discounts (0.00 to 0.10, +0.0 stored), a band number and its
rate. Three nodes run in one ``Client.run`` on a branch, published as
one commit. Each rounds its discount and tax columns to bfloat16 keys
(``l_disc_key``, ``l_tax_key``: the -0.0 lanes get bits ``0x8000``, the
NaN lanes ``0x7fc0``) and groups or joins on them:

- ``bf16_groups``: GROUP BY (``l_disc_key``, ``l_tax_key``) with COUNT,
  and the SUM, MIN and MAX of Q1's value columns that are exact on
  every backend (``l_quantity``; the MIN and MAX of
  ``l_extendedprice``). A float SUM is left out: its summation order is
  the backends' one documented carve-out (``exec/base.py``), and this
  example holds every backend to the bit;
- ``bf16_banded``: the inner join of ``lineitem`` read through Q1's
  ship-date filter with ``discount_band``, the filter fused into the
  join's masked probe (``Table.masked_join``, the entry point of the
  optimizer's ``probe_fusion``);
- ``bf16_banded_all``: the left join of all of ``lineitem`` with
  ``discount_band``.

The lake's contracts map no bfloat16 column, in the port as in
``repro``, so the keys live inside the nodes, and each node publishes
its key columns widened to float32 (exact: the bfloat16 bits, shifted).
Keys compare as ``repro``'s ``reference`` compares ``ml_dtypes``
scalars: -0.0 lanes fall in the +0.0 group and join the +0.0 band, each
NaN lane is a group of its own and joins nothing (a left join keeps it
with NULL band columns). :func:`check_keys` checks those facts on the
published tables; ``chip_smoke.py`` phase 12a runs the pipeline on the
card and holds its tables against the same run on ``vectorized``, bit
for bit, and ``tests/test_torch_bf16_keys.py`` against ``repro``'s
``reference``.

The pipeline is built from an ``api`` namespace, as ``tpch.py``'s is,
with more members: ``Client``, ``Table``, ``to_key`` (the package's cast
of a float64 array to bfloat16) and ``from_key`` (bfloat16 to float32).
So a test can build the same pipeline against another package.
"""
from __future__ import annotations

import types

import numpy as np

from repro_torch.core.runner import Client
from repro_torch.data import bfloat16
from repro_torch.data.tables import Table
from repro_torch.examples.tpch import PORT_API, Q1_SHIPDATE

__all__ = ["NEG_ZERO_EVERY", "NAN_EVERY", "TABLES", "BF16_API",
           "lineitem_for_keys", "discount_band", "keyed", "build_pipeline",
           "check_keys", "fresh_client", "run"]

NEG_ZERO_EVERY = 1000
NAN_EVERY = 997
DISCOUNTS = np.arange(11) / 100          # TPC-H §4.2.3: [0.00 .. 0.10]
TABLES = ("bf16_groups", "bf16_banded", "bf16_banded_all")
KEYS = {"l_discount": "l_disc_key", "l_tax": "l_tax_key",
        "band_discount": "l_disc_key"}
_COLUMNS = ("l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
            "l_tax", "l_shipdate")
NEG_ZERO32 = 0x80000000                  # -0.0 and the quiet NaN as
NAN32 = 0x7FC00000                       # widened float32 bits

BF16_API = types.SimpleNamespace(**vars(PORT_API), Client=Client,
                                 Table=Table, to_key=bfloat16.from_float32,
                                 from_key=bfloat16.widen)


def lineitem_for_keys(lineitem: dict[str, np.ndarray]
                      ) -> dict[str, np.ndarray]:
    """``lineitem``'s numeric columns, ``l_discount`` -0.0 at lanes ``i %
    NEG_ZERO_EVERY == NEG_ZERO_EVERY - 1`` and NaN at ``i % NAN_EVERY ==
    0`` (the NaN wins where both fall)."""
    out = {c: lineitem[c] for c in _COLUMNS}
    disc = out["l_discount"].copy()
    disc[NEG_ZERO_EVERY - 1::NEG_ZERO_EVERY] = -0.0
    disc[::NAN_EVERY] = np.nan
    out["l_discount"] = disc
    return out


def discount_band() -> dict[str, np.ndarray]:
    """The 11 discounts (+0.0 stored), their band and rate."""
    return {"band_discount": DISCOUNTS.astype(np.float64),
            "band": np.arange(len(DISCOUNTS), dtype=np.int64),
            "band_rate": DISCOUNTS.astype(np.float64)}


def keyed(t, api):
    """``t`` with its discount and tax columns as bfloat16 keys."""
    return api.Table._from_cols({
        KEYS.get(c, c): (api.to_key(v) if c in KEYS else v, ok)
        for c, (v, ok) in t._to_cols().items()})


def _published(t, api):
    """``t`` with its bfloat16 keys widened to float32 (exactly) and its
    NULL masks kept."""
    return api.Table._from_cols({
        c: (api.from_key(v) if c in KEYS.values() else v, ok)
        for c, (v, ok) in t._to_cols().items()})


def build_pipeline(api: types.SimpleNamespace = BF16_API):
    """The three nodes over ``api`` (:data:`BF16_API`'s members)."""
    S = api.S
    col, lit = api.col, api.lit
    Lines = S.Schema.of(
        "Lines", l_orderkey="int64", l_quantity="int64",
        l_extendedprice="float64", l_discount="float64", l_tax="float64",
        l_shipdate="datetime")
    Band = S.Schema.of("Band", band_discount="float64", band="int64",
                       band_rate="float64")
    Groups = S.Schema.of(
        "Groups", l_disc_key="float32", l_tax_key="float32",
        count_order="int64", sum_qty="int64", min_qty="int64",
        max_qty="int64", min_price="float64", max_price="float64")
    Banded = S.Schema.of(
        "Banded", l_orderkey="int64", l_disc_key="float32",
        l_quantity="int64", band="int64", band_rate="float64")
    BandedAll = S.Schema.of(
        "BandedAll", l_orderkey="int64", l_disc_key="float32",
        band=S.Nullable["int64"], band_rate=S.Nullable["float64"])
    shipped = col("l_shipdate") <= lit(np.datetime64(Q1_SHIPDATE, "ns"))

    p = api.Pipeline("bf16_keys")
    p.source("lineitem", Lines)
    p.source("discount_band", Band)

    @p.node()
    def bf16_groups(li: Lines = "lineitem") -> Groups:
        g = keyed(li, api).group_by(["l_disc_key", "l_tax_key"]).agg(
            ("count", "l_quantity", "count_order"),
            ("sum", "l_quantity", "sum_qty"),
            ("min", "l_quantity", "min_qty"),
            ("max", "l_quantity", "max_qty"),
            ("min", "l_extendedprice", "min_price"),
            ("max", "l_extendedprice", "max_price"))
        return _published(g, api)

    @p.node()
    def bf16_banded(li: Lines = "lineitem",
                    b: Band = "discount_band") -> Banded:
        j = keyed(li, api).masked_join(keyed(b, api), on=["l_disc_key"],
                                       left_pred=shipped)
        return _published(j.select([
            col("l_orderkey"), col("l_disc_key"), col("l_quantity"),
            col("band"), col("band_rate")]), api)

    @p.node()
    def bf16_banded_all(li: Lines = "lineitem",
                        b: Band = "discount_band") -> BandedAll:
        j = keyed(li, api).join(keyed(b, api), on=["l_disc_key"],
                                how="left")
        return _published(j.select([
            col("l_orderkey"), col("l_disc_key"), col("band"),
            col("band_rate")]), api)

    return p


class CheckFailed(AssertionError):
    """A check of the published tables failed."""


def _expect(cond, *what) -> None:
    if not cond:
        raise CheckFailed(" ".join(map(str, what)))


def _bits(t, c: str) -> np.ndarray:
    return np.ascontiguousarray(t.column(c), dtype=np.float32).view(
        np.uint32)


def check_keys(tables: dict, lineitem: dict[str, np.ndarray]) -> dict:
    """The key semantics on the published tables: the ±0.0 lanes of a
    tax key form one group; every NaN lane is its own group, joins
    nothing, and survives the left join with a NULL band; every -0.0
    lane joins the +0.0 band. Returns the counts it checked."""
    disc = lineitem["l_discount"]
    nan = np.isnan(disc)
    zero = disc == 0.0
    n_neg = int((zero & np.signbit(disc)).sum())
    groups = tables["bf16_groups"]
    gbits = _bits(groups, "l_disc_key")
    _expect(int((gbits == NAN32).sum()) == int(nan.sum()),
            "bf16_groups: the NaN lanes are not one group each")
    gzero = (gbits == 0) | (gbits == NEG_ZERO32)
    _expect(int(groups.column("count_order")[gzero].sum())
            == int(zero.sum()),
            "bf16_groups: the ±0.0 lanes are not in the zero groups")
    _expect(int(gzero.sum()) == len(np.unique(lineitem["l_tax"][zero])),
            "bf16_groups: ±0.0 of one tax key in more than one group")
    inner = tables["bf16_banded"]
    ibits = _bits(inner, "l_disc_key")
    _expect(not (ibits == NAN32).any(), "bf16_banded: a NaN key joined")
    negs = ibits == NEG_ZERO32
    _expect(negs.any() and (inner.column("band")[negs] == 0).all(),
            "bf16_banded: a -0.0 lane missed the +0.0 band")
    left = tables["bf16_banded_all"]
    _expect(len(left) == len(disc), "bf16_banded_all: rows lost")
    lbits = _bits(left, "l_disc_key")
    _expect((~left.validity("band") == (lbits == NAN32)).all(),
            "bf16_banded_all: the NULL bands are not the NaN lanes")
    _expect(int((lbits == NEG_ZERO32).sum()) == n_neg
            and (left.column("band")[lbits == NEG_ZERO32] == 0).all(),
            "bf16_banded_all: a -0.0 lane missed the +0.0 band")
    return {"rows": len(disc), "nan_lanes": int(nan.sum()),
            "neg_zero_lanes": n_neg, "groups": len(groups),
            "inner_rows": len(inner), "left_rows": len(left)}


def fresh_client(lineitem: dict[str, np.ndarray], api=BF16_API):
    """A client of ``api``'s package whose ``main`` holds the two
    sources."""
    client = api.Client()
    client.write_source_table("main", "lineitem", api.Table(lineitem))
    client.write_source_table("main", "discount_band",
                              api.Table(discount_band()))
    return client


def run(client, plan, *, branch: str = "bf16_keys", cache: bool = True):
    """Run the planned pipeline on a fresh branch and merge it into
    ``main``: the :class:`RunResult` and the published tables."""
    client.create_branch(branch, from_ref="main")
    result = client.run(plan, branch, cache=cache)
    client.merge(branch, into="main")
    return result, {t: client.read_table("main", t) for t in TABLES}
