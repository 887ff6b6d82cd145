"""Rebase-and-revalidate publication, live (DESIGN.md §7).

    PYTHONPATH=src python -m repro_torch.examples.concurrent_writers \\
        [--device cpu]

1. six agents run concurrent transactional pipelines against `main`,
   each writing its own table: every publication is a CAS; losers of a
   race rebase onto the new head, re-run their verifiers against the
   rebased state, and retry — all six publish, one commit per run;
2. the stale-verification hazard is shown directly: without CAS a
   moved `main` would be silently three-way merged into a state no
   verifier ever saw (here the verifier re-runs and logs the new base);
3. two agents fight over the SAME table: exactly one wins, the other
   aborts cleanly with its branch preserved for triage.

The port of the root ``examples/concurrent_writers.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import threading

from repro_torch.core.catalog import Catalog
from repro_torch.core.errors import TransactionAborted
from repro_torch.core.transactions import RunRegistry, TransactionalRun
from repro_torch.examples.entry import device_arg, on_device


def run():
    cat = Catalog()
    reg = RunRegistry()
    cat.write_table("main", "base", "b0")

    # -- 1: six concurrent runs, disjoint tables -----------------------------
    barrier = threading.Barrier(6)

    def agent(i):
        with TransactionalRun(cat, "main", registry=reg,
                              run_id=f"agent{i}",
                              max_publish_attempts=12) as txn:
            txn.write_table(f"metrics_{i}", f"m{i}")
            txn.verify(lambda read: read(f"metrics_{i}"))
            barrier.wait()          # all publish at once

    threads = [threading.Thread(target=agent, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    print("six concurrent runs published; main log (newest first):")
    for c in cat.log("main", limit=7):
        attempts = (reg.get_run(c.run_id).publish_attempts
                    if c.run_id else "-")
        print(f"  {c.id[:8]}  run={c.run_id or '<seed>':8} "
              f"CAS-attempts={attempts}")
    for st in reg.runs():
        assert st.final_commit == st.verified_head, "unverified publish!"
    print("every published commit == the head its verifiers validated\n")

    # -- 2: the verifier observes the rebase ---------------------------------
    seen = []
    txn = TransactionalRun(cat, "main").begin()
    txn.write_table("report", "r1")
    txn.verify(lambda read: seen.append(read("base")))
    cat.write_table("main", "base", "b1")       # main moves under us
    txn.commit()
    print(f"verifier ran against base={seen[0]!r}, then re-ran against "
          f"the rebased base={seen[1]!r} before publishing "
          f"(attempts={txn.publish_attempts})\n")

    # -- 3: same-table race: one winner, one clean abort ---------------------
    b2 = threading.Barrier(2)
    outcome = {}

    def fighter(i):
        txn = TransactionalRun(cat, "main", run_id=f"fight{i}").begin()
        txn.write_table("hot", f"h{i}")
        txn.verify(lambda read: read("hot"))
        b2.wait()
        try:
            txn.commit()
            outcome[i] = "committed"
        except TransactionAborted:
            outcome[i] = f"aborted (branch {txn.branch} kept for triage)"

    ts = [threading.Thread(target=fighter, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for i, o in sorted(outcome.items()):
        print(f"fight{i}: {o}")
    print(f"main hot={cat.read_table('main', 'hot')!r} — exactly one "
          f"winner, no silent combine")



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
