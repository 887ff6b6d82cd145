"""Worked example: the SQL front door end to end (DESIGN.md §13).

    PYTHONPATH=src python -m repro_torch.examples.sql_queries [--device cpu]

One method call — ``Client.sql(query, ref=...)`` — runs the whole
paper pipeline in miniature: the catalog resolves the ref to a pinned
commit, the snapshot *manifests* (no column data) synthesize a
contract per table, the query compiles to the same logical IR
hand-built declarative nodes use, the plan flows through ``optimize()``
with EXPLAIN provenance, the stats-driven ``auto`` backend executes
it, and the result caches content-addressed by the *logical tree* —
so any respelling of the query at the same commit is a zero-execution
metadata hit.

Things to watch for in the output:

- the EXPLAIN header quotes the original query text, then shows what
  the optimizer did to it (pushdown, pruning, probe fusion);
- the inferred output contract: dtypes computed by evaluating the
  compiled expressions with the real kernels, nullability widened on
  the right side of the LEFT JOIN, lineage on pass-through columns;
- the second run reporting ``executed=()`` — same commit, same tree,
  nothing to do — even though the spelling changed;
- the unknown-column error naming the ref and suggesting a fix: the
  message an agent retries from.

The port of the root ``examples/sql_queries.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import numpy as np

from repro_torch.core.runner import Client
from repro_torch.data.tables import Table
from repro_torch.sql.errors import SqlCompileError
from repro_torch.examples.entry import device_arg, on_device


def build_client():
    client = Client()
    rng = np.random.default_rng(7)
    n = 20_000
    client.write_source_table("main", "fact", Table({
        "user_id": rng.integers(0, 900, n),
        "item_id": rng.integers(0, 200, n),
        "amount": np.round(rng.gamma(2.0, 30.0, n), 2),
    }), message="facts")
    client.write_source_table("main", "users", Table({
        "user_id": np.arange(800, dtype=np.int64),   # 100 ids unmatched
        "segment": (np.arange(800) % 16).astype(np.int64),
        "name": np.array([f"user-{i}" for i in range(800)],
                         dtype=object),
    }), message="users dimension")
    client.write_source_table("main", "items", Table({
        "item_id": np.arange(200, dtype=np.int64),
        "weight": rng.normal(size=200),
    }), message="items dimension")
    return client


def run():
    client = build_client()

    # -- 1. a star query with GROUP BY, compiled from text ----------------
    query = ("SELECT u.name, SUM(f.amount) AS total, "
             "COUNT(f.amount) AS orders "
             "FROM fact f "
             "JOIN users u ON f.user_id = u.user_id "
             "JOIN items i ON f.item_id = i.item_id "
             "WHERE u.segment = 3 "
             "GROUP BY u.name ORDER BY total DESC LIMIT 5")
    result = client.sql(query)
    print("=== EXPLAIN (plan.describe()) ===")
    print(result.describe())
    print()
    print("=== inferred output contract ===")
    for c in result.schema.columns().values():
        print(f"  {c.describe()}")
    print()
    print("=== top spenders in segment 3 ===")
    for name, total, cnt in zip(result.table.column("name"),
                                result.table.column("total"),
                                result.table.column("orders")):
        print(f"  {name:>10}  {total:9.2f}  ({cnt} orders)")
    print()

    # -- 2. respell the query: same logical tree, zero executions ---------
    respelled = " ".join(query.lower().split())
    rerun = client.sql(respelled)
    print("=== respelled rerun at the same commit ===")
    print(f"  executed={rerun.executed!r} cached={rerun.cached!r}")
    print(f"  fingerprints equal: "
          f"{rerun.fingerprint() == result.fingerprint()}")
    print()

    # -- 3. LEFT JOIN: inferred nullability widens -------------------------
    left = client.sql(
        "SELECT f.user_id, f.amount, u.name FROM fact f "
        "LEFT JOIN users u ON f.user_id = u.user_id")
    names = left.table._data["name"]
    n_null = 0 if names.valid is None else int((~names.valid).sum())
    print("=== LEFT JOIN: contract inference ===")
    print(f"  name column declared: "
          f"{left.schema.columns()['name'].describe()}")
    print(f"  unmatched fact rows (NULL name): {n_null}")
    print()

    # -- 4. the error an agent retries from --------------------------------
    print("=== unknown column: compile-time error naming the ref ===")
    try:
        client.sql("SELECT u.nmae FROM users u")
    except SqlCompileError as e:
        print(f"  {e}")



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
