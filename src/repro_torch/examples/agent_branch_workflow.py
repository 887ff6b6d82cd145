"""Agentic collaboration + the Fig. 4 counterexample, live.

    PYTHONPATH=src python -m repro_torch.examples.agent_branch_workflow \\
        [--device cpu]

1. an agent proposes a pipeline change on an isolated branch;
2. a human reviews the diff and merges (the PR flow for data);
3. a user's run aborts, leaving a dangling transactional branch;
4. a second agent tries to build on the aborted branch and merge —
   the visibility guardrail refuses (paper Fig. 4 made unrepresentable);
5. the sanctioned path: allow_reuse -> quarantine -> re-verify -> merge.

The port of the root ``examples/agent_branch_workflow.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import numpy as np

from repro_torch.core.catalog import Visibility
from repro_torch.core.errors import TransactionAborted, VisibilityError
from repro_torch.core.runner import Client
from repro_torch.core.transactions import TransactionalRun
from repro_torch.data.tables import Table
from repro_torch.examples.entry import device_arg, on_device


def run():
    client = Client()
    cat = client.catalog
    client.write_source_table("main", "sales",
                              Table({"amount": np.array([100, 200, 300])}))

    # -- 1+2: agent proposes on a branch; human reviews and merges ----------
    cat.create_branch("agent/cleanup", "main")
    with TransactionalRun(cat, "agent/cleanup", code="dedup-v1",
                          registry=client.registry) as txn:
        txn.write_table("sales_clean", "snap-dedup-1")
    print("agent proposed:", cat.diff("main", "agent/cleanup"))
    cat.merge("agent/cleanup", into="main")        # human-approved PR
    print("after review+merge, main tables:",
          sorted(cat.tables("main")))

    # -- 3: a run fails mid-pipeline -----------------------------------------
    try:
        with TransactionalRun(cat, "main", registry=client.registry) as t2:
            t2.write_table("P", "P-new")
            raise RuntimeError("node 'child' OOMed")
    except RuntimeError:
        pass
    aborted = t2.branch
    print(f"\nrun {t2.run_id} aborted; branch {aborted!r} kept for triage")
    print("  triage read:", cat.read_table(aborted, "P"))
    print("  main is untouched:", sorted(cat.tables("main")))

    # -- 4: the Fig. 4 hazard is refused --------------------------------------
    try:
        cat.create_branch("agent/opportunist", aborted)
    except VisibilityError as e:
        print(f"\n[guardrail] {e}")

    # -- 5: the sanctioned reuse path (idempotent re-run optimization) --------
    cat.create_branch("retry/child-fix", aborted, allow_reuse=True)
    info = cat.branch_info("retry/child-fix")
    print(f"\nreuse allowed -> visibility={info.visibility.value}")
    cat.write_table("retry/child-fix", "C", "C-recomputed")
    try:
        cat.merge("retry/child-fix", into="main")
    except VisibilityError as e:
        print(f"[guardrail] merge before re-verification: {e}")
    # re-run verifiers on the quarantined branch, then mark verified
    cat.mark("retry/child-fix", Visibility.QUARANTINED, verified=True)
    cat.merge("retry/child-fix", into="main")
    print("after re-verification the merge is legal; main:",
          sorted(cat.tables("main")))



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
