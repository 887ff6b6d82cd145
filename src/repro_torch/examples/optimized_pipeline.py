"""Worked example: the logical-plan optimizer end to end (DESIGN.md §11).

    PYTHONPATH=src python -m repro_torch.examples.optimized_pipeline \\
        [--device cpu]

A three-table star pipeline — facts joined to two dimensions, a
selective filter authored at the top, a narrow projection — planned,
optimized, EXPLAINed, and executed both ways to show the optimizer's
contract: same published bytes, less work.

What the passes do to this pipeline:

- *filter_pushdown* moves ``segment == 3`` from above both joins down
  onto the ``users`` side (it only reads users columns);
- *join_reorder* probes the estimated-smaller dimension first when
  the planner's TableStats say the authored order is backwards;
- *column_pruning* stops reading the payload columns nothing
  references (they never appear in the projection, the join keys, or
  the output contract);
- *probe_fusion* turns the pushed-down filter into a masked join
  probe, so the filtered users table is never materialized at all.

The port of the root ``examples/optimized_pipeline.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import numpy as np

from repro_torch.core import schema as S
from repro_torch.core.dag import Pipeline
from repro_torch.core.planner import plan
from repro_torch.core.runner import Client
from repro_torch.data.tables import Table, col
from repro_torch.exec.stats import collect_stats
from repro_torch.optimizer import optimize
from repro_torch.examples.entry import device_arg, on_device


class Fact(S.Schema):
    user_id: int
    item_id: int
    amount: float
    payload: float        # referenced by nothing: elision fodder


class Users(S.Schema):
    user_id: int
    segment: int
    bio: str              # referenced by nothing: elision fodder


class Items(S.Schema):
    item_id: int
    weight: float


class Out(S.Schema):
    user_id: int
    amount: float
    weight: float


def build_sources():
    rng = np.random.default_rng(0)
    n = 50_000
    fact = Table({"user_id": rng.integers(0, 5_000, n),
                  "item_id": rng.integers(0, 800, n),
                  "amount": rng.normal(size=n),
                  "payload": rng.normal(size=n)})
    users = Table({"user_id": np.arange(5_000, dtype=np.int64),
                   "segment": (np.arange(5_000) % 32).astype(np.int64),
                   "bio": np.array([f"user {i}" for i in range(5_000)],
                                   dtype=object)})
    items = Table({"item_id": np.arange(800, dtype=np.int64),
                   "weight": rng.normal(size=800)})
    return {"fact": fact, "users": users, "items": items}


def build_pipeline() -> Pipeline:
    p = Pipeline("star_example")
    p.source("fact", Fact)
    p.source("users", Users)
    p.source("items", Items)
    # authored naively: join everything, THEN filter, then project —
    # exactly the shape a human (or an agent) writes first.
    p.sql(name="out", inputs={"f": "fact", "u": "users", "i": "items"},
          input_schemas={"f": Fact, "u": Users, "i": Items},
          output_schema=Out,
          joins=[("users", ["user_id"]), ("items", ["item_id"])],
          filter_expr=(col("segment") == 3),
          exprs=[col("user_id"), col("amount"), col("weight")])
    return p


def run():
    sources = build_sources()

    # plan-time statistics feed the cost model (join_reorder) and the
    # auto backend; they are observability metadata, never semantics.
    stats = {name: collect_stats(t._to_cols())
             for name, t in sources.items()}
    pl = plan(build_pipeline(), table_stats=stats)
    opt = optimize(pl)

    print("== EXPLAIN (optimized) ==")
    print(opt.describe())
    print()
    print("== rewritten tree ==")
    print(opt.steps[0].logical.describe())
    print()

    # run both ways; published bytes must be identical — that is the
    # rewrite-pass contract, enforced at scale by the differential
    # suite and the benchmark gate.
    fingerprints = {}
    for label, p in (("unoptimized", pl), ("optimized", opt)):
        client = Client()
        for name, t in sources.items():
            client.write_source_table("main", name, t)
        res = client.run(p, "main")
        out = client.read_table("main", "out")
        fingerprints[label] = out.fingerprint()
        print(f"{label:>12}: {len(out)} rows, executed={res.executed}, "
              f"fingerprint={out.fingerprint()}")

    assert fingerprints["unoptimized"] == fingerprints["optimized"]
    print("\nbit-for-bit: OK")



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
