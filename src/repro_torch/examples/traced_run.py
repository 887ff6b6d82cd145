"""Auditing a rebase-heavy run from its flight-recorder manifest
(DESIGN.md §14).

    PYTHONPATH=src python -m repro_torch.examples.traced_run [--device cpu]

The scenario an agent faces after the fact: "my pipeline published,
but main moved under it twice while it ran — what actually happened?"
With tracing on, the answer is no longer re-running with print
statements; the committed manifest IS the answer:

1. a traced transactional run suffers two injected head movements: a
   concurrent writer bumps `main` during verification, so publication
   conflicts, rebases, re-validates, and retries;
2. the published commit anchors a manifest —
   ``Catalog.run_manifest(commit)`` — holding the full span tree:
   publication attempts with outcomes, ref-conflict details
   (expected vs actual head), which nodes re-executed and which hit
   the content-addressed cache, per-node wall times, and every
   backend/auto decision with its reason;
3. the audit walks the tree like an agent would: reconstruct the
   retry story, bill the run's time to phases, and confirm from
   metrics that nothing degraded silently.

The port of the root ``examples/traced_run.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import numpy as np

import repro_torch.obs as obs
from repro_torch.core import schema as S
from repro_torch.core.dag import Pipeline
from repro_torch.core.planner import plan
from repro_torch.core.runner import Client
from repro_torch.data.tables import Table, col
from repro_torch.examples.entry import device_arg, on_device

Src = S.Schema.of("Src", x=int)
Mid = S.Schema.of("Mid", x=int, y=int)
Total = S.Schema.of("Total", total=int)


def build_pipeline() -> Pipeline:
    p = Pipeline("nightly_rollup")
    p.source("src", Src)

    for i in range(3):
        def make(mult):
            def mid(df: Src = "src") -> Mid:
                return df.select([col("x"),
                                  (col("x") * mult).alias("y")])
            return mid
        p.node(name=f"mid_{i}")(make(i + 1))

    @p.node()
    def sink(a: Mid = "mid_0", b: Mid = "mid_1", c: Mid = "mid_2") -> Total:
        total = int(a.column("y").sum() + b.column("y").sum()
                    + c.column("y").sum())
        return Table({"total": np.array([total], dtype=np.int64)})

    return p


def run():
    client = Client()
    client.write_source_table(
        "main", "src", Table({"x": np.arange(5, dtype=np.int64)}))
    pl = plan(build_pipeline())

    # -- 1: run traced, with main moving underneath us twice -----------------
    bumps = iter(((10, 20), (30, 40)))

    def hostile_verifier(_table):
        vals = next(bumps, None)        # first two verifications only
        if vals is not None:
            client.write_source_table(
                "main", "src",
                Table({"x": np.array(vals, dtype=np.int64)}))

    with obs.tracing():
        res = client.run(pl, "main",
                         verifiers={"sink": [hostile_verifier]})
    print(f"published {res.state.final_commit[:8]} after "
          f"{res.state.publish_attempts} publication attempts "
          f"(re-executed per rebase: {res.rebase_reexecutions})\n")

    # -- 2: the manifest is anchored to the commit ---------------------------
    man = client.catalog.run_manifest(res.state.final_commit)
    assert man is not None
    spans = man["spans"]
    by_id = {s["span_id"]: s for s in spans}
    print(f"manifest: run {man['run_id']} -> commit "
          f"{man['commit_id'][:8]}, {len(spans)} spans")

    # -- 3: the audit, from the tree alone -----------------------------------
    print("\npublication story:")
    for att in sorted((s for s in spans
                       if s["name"] == "publication_attempt"),
                      key=lambda s: s["attrs"]["attempt"]):
        a = att["attrs"]
        line = f"  attempt {a['attempt']}: {a['outcome']}"
        for ev in att["events"]:
            if ev["name"] == "ref_conflict":
                line += (f"  (expected head {ev['expected_head'][:8]}, "
                         f"found {ev['actual_head'][:8]})")
        print(line)

    print("\nwho re-executed vs who hit the cache, per attempt:")
    for node in (s for s in spans if s["name"] == "node"):
        parent = by_id.get(by_id.get(node["parent_id"], {})
                           .get("parent_id"))
        phase = "initial run"
        if parent is not None and parent["name"] == "reexecute":
            phase = "rebase re-execution"
        a = node["attrs"]
        wall_ms = (node["t1"] - node["t0"]) * 1e3
        print(f"  {a['node']:8} {a['cache']:4} "
              f"rows_out={a['rows_out']:>2} "
              f"{wall_ms:7.2f}ms  [{phase}]")

    print("\nverifier outcomes:")
    for v in (s for s in spans if s["name"] == "verifier"):
        a = v["attrs"]
        print(f"  {a['fn']:20} phase={a['phase']:10} {a['outcome']}")

    print("\nbilled time by phase:")
    for name in ("rebase", "revalidate", "reexecute"):
        total = sum(s["t1"] - s["t0"] for s in spans
                    if s["name"] == name)
        print(f"  {name:10} {total * 1e3:7.2f}ms "
              f"x{sum(1 for s in spans if s['name'] == name)}")

    m = man["metrics"]["counters"]
    print(f"\nmetrics: rebases={m.get('txn.rebases', 0)} "
          f"conflicts={m.get('txn.publication.conflicts', 0)} "
          f"cache misses={m.get('engine.cache.misses', 0)} "
          f"hits={m.get('engine.cache.hits', 0)} "
          f"degradations={m.get('exec.numpy_fallbacks', 0)}")

    # -- and the invariant that makes tracing safe to leave on ---------------
    rerun = client.run(pl, "main")
    print(f"\nuntraced rerun at the same head: executed "
          f"{len(rerun.executed)} nodes, {len(rerun.cached)} cache "
          f"hits — tracing is never key material, so traced and "
          f"untraced runs share cache entries bit-for-bit")



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
