"""TPC-H Q1 and Q18 as one transactional pipeline: the port's first slice.

    PYTHONPATH=src python -m repro_torch.examples.tpch --sf 1
    PYTHONPATH=src python -m repro_torch.examples.tpch --sf 0.01 --device cpu

Two source tables are generated from ``--seed`` with numpy, to the
column domains of the TPC-H Standard Specification v3.0.1 (§4.2.3
cardinalities and domains, §4.2.5 scaling): ``lineitem`` (6,001,215 rows
at SF1) and ``orders`` (1,500,000 rows at SF1). Three typed nodes run in
one ``Pipeline``:

- ``pricing_summary`` — Q1 (§2.4.1): the ship-date filter, ``disc_price``
  and ``charge``, then GROUP BY (l_returnflag, l_linestatus) with
  SUM x4, MEAN x3 and COUNT: a few groups with very long runs;
- ``order_lines`` — Q18's inner query (§2.4.18): lineitem grouped by
  order key with SUM(l_quantity), COUNT and MIN/MAX(l_extendedprice):
  ~1.5M groups of ~4 rows;
- ``large_orders`` — Q18's outer query: ``order_lines`` joined to
  ``orders``, keeping sum_qty > 300 (the customer table is left out).

``Client.run`` publishes all three on a branch in ONE commit, and the
branch then merges into ``main``. Group-by aggregation runs on the
execution backend the caller selects (``torch`` on the card by default).

The pipeline is built from an ``api`` namespace (schema module,
``Pipeline``, ``col``, ``lit``), so a test can build the same pipeline
against another package that shares this API.
"""
from __future__ import annotations

import argparse
import json
import time
import types

import numpy as np

from repro_torch.core import schema as S
from repro_torch.core.dag import Pipeline
from repro_torch.data.tables import col, lit

__all__ = ["PORT_API", "generate", "build_pipeline", "run_slice",
           "LINEITEM_ROWS_SF1", "ORDERS_ROWS_SF1"]

PORT_API = types.SimpleNamespace(S=S, Pipeline=Pipeline, col=col, lit=lit)

LINEITEM_ROWS_SF1 = 6_001_215
ORDERS_ROWS_SF1 = 1_500_000
CUSTOMERS_SF1 = 150_000
PARTS_SF1 = 200_000
STARTDATE = np.datetime64("1992-01-01")
CURRENTDATE = np.datetime64("1995-06-17")
ENDDATE = np.datetime64("1998-12-31")
Q1_SHIPDATE = "1998-09-02"      # DATE '1998-12-01' - INTERVAL '90' DAY
Q18_QUANTITY = 300


def _lines_per_order(rng, n_orders: int, n_lines: int) -> np.ndarray:
    """1..7 lines per order (§4.2.3), nudged so the total is exactly
    ``n_lines`` (dbgen's count at this scale)."""
    lines = rng.integers(1, 8, n_orders)
    diff = n_lines - int(lines.sum())
    while diff:
        step = 1 if diff > 0 else -1
        room = np.flatnonzero(lines < 7 if step > 0 else lines > 1)
        pick = rng.choice(room, size=min(abs(diff), len(room)),
                          replace=False)
        lines[pick] += step
        diff -= step * len(pick)
    return lines


def generate(sf: float, seed: int) -> dict[str, dict[str, np.ndarray]]:
    """``{"lineitem": columns, "orders": columns}`` at scale factor
    ``sf``, as plain numpy columns (strings as object arrays, dates as
    ``datetime64[ns]``)."""
    rng = np.random.default_rng(seed)
    n_orders = max(1, round(ORDERS_ROWS_SF1 * sf))
    n_lines = max(n_orders, round(LINEITEM_ROWS_SF1 * sf))
    i = np.arange(n_orders, dtype=np.int64)
    orderkey = (i // 8) * 32 + (i % 8) + 1       # 8 of every 32 keys used
    n_cust = max(3, round(CUSTOMERS_SF1 * sf))
    k = rng.integers(0, 2 * n_cust // 3, n_orders)
    custkey = k + k // 2 + 1                     # skips multiples of 3
    span = int((ENDDATE - np.timedelta64(151, "D") - STARTDATE)
               / np.timedelta64(1, "D"))
    orderday = rng.integers(0, span + 1, n_orders)

    lines = _lines_per_order(rng, n_orders, n_lines)
    n = int(lines.sum())
    quantity = rng.integers(1, 51, n).astype(np.int64)
    n_part = max(1, round(PARTS_SF1 * sf))
    partkey = rng.integers(1, n_part + 1, n)
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)) / 100
    extendedprice = np.round(quantity * retail, 2)
    discount = rng.integers(0, 11, n) / 100
    tax = rng.integers(0, 9, n) / 100
    shipday = np.repeat(orderday, lines) + rng.integers(1, 122, n)
    receiptday = shipday + rng.integers(1, 31, n)
    current = int((CURRENTDATE - STARTDATE) / np.timedelta64(1, "D"))
    returned = np.array(["R", "A"], dtype=object)[rng.integers(0, 2, n)]
    returnflag = np.where(receiptday <= current, returned,
                          np.array("N", dtype=object))
    linestatus = np.where(shipday > current, "O", "F").astype(object)
    starts = np.r_[0, np.cumsum(lines)[:-1]]
    totalprice = np.round(np.add.reduceat(
        extendedprice * (1 + tax) * (1 - discount), starts), 2)

    def dates(days):
        return (STARTDATE + days.astype("timedelta64[D]")).astype(
            "datetime64[ns]")

    return {
        "lineitem": {
            "l_orderkey": np.repeat(orderkey, lines),
            "l_quantity": quantity,
            "l_extendedprice": extendedprice,
            "l_discount": discount,
            "l_tax": tax,
            "l_returnflag": returnflag.astype(object),
            "l_linestatus": linestatus,
            "l_shipdate": dates(shipday),
        },
        "orders": {
            "o_orderkey": orderkey,
            "o_custkey": custkey.astype(np.int64),
            "o_totalprice": totalprice,
            "o_orderdate": dates(orderday),
        },
    }


def build_pipeline(api: types.SimpleNamespace = PORT_API):
    """The three-node TPC-H pipeline over ``api``'s Schema, Pipeline,
    col and lit."""
    Schema = api.S.Schema
    col, lit = api.col, api.lit
    LineItem = Schema.of(
        "LineItem", l_orderkey="int64", l_quantity="int64",
        l_extendedprice="float64", l_discount="float64", l_tax="float64",
        l_returnflag="str", l_linestatus="str", l_shipdate="datetime")
    Orders = Schema.of(
        "Orders", o_orderkey="int64", o_custkey="int64",
        o_totalprice="float64", o_orderdate="datetime")
    PricingSummary = Schema.of(
        "PricingSummary", l_returnflag="str", l_linestatus="str",
        sum_qty="int64", sum_base_price="float64",
        sum_disc_price="float64", sum_charge="float64",
        avg_qty="float64", avg_price="float64", avg_disc="float64",
        count_order="int64")
    OrderLines = Schema.of(
        "OrderLines", o_orderkey="int64", sum_qty="int64",
        n_lines="int64", min_price="float64", max_price="float64")
    LargeOrders = Schema.of(
        "LargeOrders", o_custkey="int64", o_orderkey="int64",
        o_orderdate="datetime", o_totalprice="float64", sum_qty="int64")

    p = api.Pipeline("tpch")
    p.source("lineitem", LineItem)
    p.source("orders", Orders)

    @p.node()
    def pricing_summary(li: LineItem = "lineitem") -> PricingSummary:
        shipped = li.filter(
            col("l_shipdate") <= lit(np.datetime64(Q1_SHIPDATE, "ns")))
        disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
        priced = shipped.select([
            col("l_returnflag"), col("l_linestatus"), col("l_quantity"),
            col("l_extendedprice"), col("l_discount"),
            disc_price.alias("disc_price"),
            (disc_price * (lit(1.0) + col("l_tax"))).alias("charge"),
        ])
        return priced.group_by(["l_returnflag", "l_linestatus"]).agg(
            ("sum", "l_quantity", "sum_qty"),
            ("sum", "l_extendedprice", "sum_base_price"),
            ("sum", "disc_price", "sum_disc_price"),
            ("sum", "charge", "sum_charge"),
            ("mean", "l_quantity", "avg_qty"),
            ("mean", "l_extendedprice", "avg_price"),
            ("mean", "l_discount", "avg_disc"),
            ("count", "l_quantity", "count_order"))

    p.sql(name="order_lines", inputs={"li": "lineitem"},
          input_schemas={"li": LineItem}, output_schema=OrderLines,
          group_keys=["l_orderkey"],
          agg_specs=[("sum", "l_quantity", "sum_qty"),
                     ("count", "l_quantity", "n_lines"),
                     ("min", "l_extendedprice", "min_price"),
                     ("max", "l_extendedprice", "max_price")],
          exprs=[col("l_orderkey").alias("o_orderkey"), col("sum_qty"),
                 col("n_lines"), col("min_price"), col("max_price")])
    p.sql(name="large_orders",
          inputs={"ol": "order_lines", "o": "orders"},
          input_schemas={"ol": OrderLines, "o": Orders},
          output_schema=LargeOrders,
          join_with="orders", join_on=["o_orderkey"],
          filter_expr=col("sum_qty") > lit(Q18_QUANTITY),
          exprs=[col("o_custkey"), col("o_orderkey"), col("o_orderdate"),
                 col("o_totalprice"), col("sum_qty")])
    return p


def run_slice(client, plan, *, branch: str = "tpch", cache: bool = True):
    """Run a planned pipeline on a fresh branch (one commit for all its
    outputs) and merge the branch into ``main``; returns the
    :class:`RunResult`. The engine leaves each node's wall time on the
    plan (``plan.describe(analyze=True)``)."""
    client.create_branch(branch, from_ref="main")
    result = client.run(plan, branch, cache=cache)
    client.merge(branch, into="main")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.planner import plan
    from repro_torch.core.runner import Client
    from repro_torch.data.tables import Table
    from repro_torch.exec import use_backend
    from repro_torch.exec.torch_backend import TorchBackend

    t0 = time.perf_counter()
    data = generate(args.sf, args.seed)
    client = Client()
    for name, cols in data.items():
        client.write_source_table("main", name, Table(cols))
    t1 = time.perf_counter()
    with use_backend(TorchBackend(device=args.device)):
        pl = plan(build_pipeline())
        result = run_slice(client, pl)
    t2 = time.perf_counter()
    print(json.dumps({
        "sf": args.sf, "rows": {k: len(next(iter(v.values())))
                                for k, v in data.items()},
        "setup_s": t1 - t0, "run_s": t2 - t1,
        "status": result.state.status,
        "node_wall_s": {k: v["wall_s"] for k, v in pl._runtime.items()},
        "fingerprints": {t: client.read_table("main", t).fingerprint()
                         for t in sorted(result.tables)}}))


if __name__ == "__main__":
    main()
