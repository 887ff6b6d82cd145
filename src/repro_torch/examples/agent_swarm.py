"""A 64-agent swarm, audited entirely from run manifests.

    PYTHONPATH=src python -m repro_torch.examples.agent_swarm [--device cpu]

64 concurrent agents publish against one catalog while a seeded fault
plan crashes some of them at publication seams, a few abandon their
branches, a few write contract-violating state, and a janitor runs
``Catalog.gc`` against the live-run heartbeat set. Afterwards:

1. the linearizability checker proves the surviving history is clean
   (every published commit verified, atomic, exactly-once);
2. the audit is reconstructed *post hoc* from commit-anchored run
   manifests (DESIGN.md §14) — for every commit on ``main``, who
   published it, in how many CAS attempts, across how many spans —
   without consulting the in-memory records the swarm kept;
3. the GC ledger shows the debris (crashed, abandoned, aborted
   branches) was collected without touching published ancestry.

The port of the root ``examples/agent_swarm.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import repro_torch.obs as obs
from repro_torch.chaos import FaultRule, SwarmConfig, check_swarm, run_swarm
from repro_torch.examples.entry import device_arg, on_device

CONFIG = SwarmConfig(
    n_agents=64, runs_per_agent=1, seed="example-64",
    hot_tables=3, p_contended=0.4, p_multi=0.15,
    p_violate=0.08, p_abandon=0.06, p_reuse=0.08,
    gc_every=8, use_store=True,
    fault_rules=(FaultRule("txn.commit.post_merge", "crash", 0.06),
                 FaultRule("txn.commit.pre_merge", "delay", 0.3,
                           delay_s=0.002),
                 FaultRule("store.put", "fail", 0.05)),
    fault_budget=10)


def run():
    with obs.tracing():
        res = run_swarm(CONFIG)

    print(f"swarm: {CONFIG.n_agents} agents, seed {CONFIG.seed!r}")
    print(f"outcomes: {res.outcomes()}")
    print(f"faults injected: {res.plan.faults_injected} "
          f"(budget {CONFIG.fault_budget}): {res.plan.injected}")

    violations = check_swarm(res)
    assert not violations, violations
    print("\nlinearizability: 0 violations — every published commit "
          "verified, atomic, exactly-once\n")

    # -- the audit: walk main and ask each commit who made it ---------------
    cat = res.catalog
    chain = [c for c in reversed(cat.log("main", limit=10_000))
             if c.run_id is not None]
    print(f"audit of {len(chain)} published commits, from manifests only:")
    traced = 0
    for c in chain:
        m = cat.run_manifest(c.id)
        if m is None:
            # lost-ack crashes (and failed audit writes) die between
            # the merge and the manifest anchor — the publication is
            # real, the audit reads back "untraced"
            print(f"  {c.id[:8]}  {c.run_id:<22} (no manifest: died "
                  f"after merge, before the audit anchor)")
            continue
        traced += 1
        root = next(s for s in m["spans"]
                    if s["span_id"] == m["root_span_id"])
        parent = cat.commit(c.parents[0]).tables if c.parents else {}
        delta = sorted(t for t, s in c.tables.items()
                       if parent.get(t) != s)
        print(f"  {c.id[:8]}  {m['run_id']:<22} "
              f"attempts={root['attrs'].get('publish_attempts', '?')} "
              f"spans={len(m['spans'])} wrote={delta}")
        assert m["commit_id"] == c.id and m["run_id"] == c.run_id
    print(f"({traced}/{len(chain)} commits carry manifests)")

    # -- the GC ledger ------------------------------------------------------
    swept = sum(len(r.collected) for r in res.gc_reports)
    print(f"\njanitor passes while agents ran: {len(res.gc_reports)} "
          f"({swept} branches collected mid-swarm)")
    if res.final_gc is not None:
        print(f"final sweep: collected "
              f"{[n for n, _ in res.final_gc.collected]}")
    print(f"branches left: {cat.branches()}")
    print(f"main tables: {len(cat.tables('main'))}")



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
