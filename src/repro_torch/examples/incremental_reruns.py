"""Incremental, wave-parallel pipeline runs (DESIGN.md §8).

The agentic-lakehouse workflow: many iterations over the same DAG where
only a slice of the inputs moves between runs. The wave engine executes
independent nodes concurrently, and the content-addressed function
cache makes a re-run pay only for the *changed subgraph* — a fully
unchanged re-run executes zero nodes and publishes zero commits.

Run: ``PYTHONPATH=src python -m repro_torch.examples.incremental_reruns
[--device cpu]``

The port of the root ``examples/incremental_reruns.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import numpy as np

from repro_torch.core import schema as S
from repro_torch.core.dag import Pipeline
from repro_torch.core.planner import plan
from repro_torch.core.runner import Client
from repro_torch.data.tables import Table, col
from repro_torch.examples.entry import device_arg, on_device

Events = S.Schema.of("Events", user=str, amount=int)
Refs = S.Schema.of("Refs", user=str, bonus=int)
PerUser = S.Schema.of("PerUser", user=str, _S=int)
Enriched = S.Schema.of("Enriched", user=str, _S=int, bonus=int)


def build() -> Pipeline:
    p = Pipeline("incremental_demo")
    p.source("events", Events)
    p.source("referrals", Refs)

    @p.node()                       # wave 0 — depends on events only
    def per_user(df: Events = "events") -> PerUser:
        return df.group_by_sum(["user"], "amount", out="_S")

    @p.node()                       # wave 0 — depends on referrals only
    def bonuses(df: Refs = "referrals") -> Refs:
        return df.select([col("user"), col("bonus")])

    @p.node()                       # wave 1 — joins both subgraphs
    def enriched(agg: PerUser = "per_user",
                 ref: Refs = "bonuses") -> Enriched:
        return agg.join(ref, on=["user"])

    return p


def report(tag, res):
    print(f"  {tag}: executed={sorted(res.executed) or '[]'} "
          f"cached={sorted(res.cached) or '[]'} "
          f"rebase_reexecutions={list(res.rebase_reexecutions)}")


def run() -> None:
    client = Client()
    client.write_source_table("main", "events", Table({
        "user": np.array(["ann", "ann", "bob"], dtype=object),
        "amount": np.array([10, 5, 7], dtype=np.int64)}))
    client.write_source_table("main", "referrals", Table({
        "user": np.array(["ann", "bob"], dtype=object),
        "bonus": np.array([1, 2], dtype=np.int64)}))

    pl = plan(build())
    print("plan waves:")
    for w, steps in enumerate(pl.waves):
        print(f"  wave {w}: {[s.node.name for s in steps]}")

    print("\nrun 1 — cold: every node executes")
    report("run 1", client.run(pl, "main"))

    print("run 2 — nothing changed: zero executions, zero new commits")
    head = client.catalog.head("main").id
    report("run 2", client.run(pl, "main"))
    assert client.catalog.head("main").id == head

    print("run 3 — only `referrals` moved: events subgraph stays cached")
    client.write_source_table("main", "referrals", Table({
        "user": np.array(["ann", "bob"], dtype=object),
        "bonus": np.array([3, 4], dtype=np.int64)}))
    res = client.run(pl, "main")
    report("run 3", res)
    assert sorted(res.executed) == ["bonuses", "enriched"]

    out = client.read_table("main", "enriched")
    print(f"\nenriched@main: {out.to_pydict()}")



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
