"""The port's copies of the paper's entry points against the root
``examples/*.py``.

Each case runs the root script under ``repro`` and the port's
``repro_torch.examples.<name>.main(device="cpu")`` in this process and
compares what they print, line by line. Only what cannot agree between
two runs or two packages is masked, each mask with its reason
(:data:`MASKS`, and the two threaded examples' normalizers below). No
mask touches table contents, statuses, verdicts, error messages or
linearizability results. ``serve_pinned_commit`` serves ``repro``'s
``init_params(PRNGKey(0))``, carried across with
``repro_torch.convert``, so its served tokens compare too.
"""
import contextlib
import importlib
import importlib.util
import io
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "agent_branch_workflow", "incremental_reruns",
            "optimized_pipeline", "sql_queries", "traced_run",
            "concurrent_writers", "agent_swarm", "serve_pinned_commit"]

RUN_ID = (r"run_[0-9a-f]{12}", "run_<id>",
          "a run id is drawn from uuid4 in each run")
MASKS = {
    "quickstart": [RUN_ID],
    "agent_branch_workflow": [RUN_ID],
    "incremental_reruns": [],
    "optimized_pipeline": [],
    "sql_queries": [],
    "traced_run": [
        RUN_ID,
        (r" *\d+\.\d+ms", " <ms>",
         "the spans' wall times differ in every run (and so does their "
         "padding to a fixed width)"),
    ],
    "concurrent_writers": [
        (r"^  [0-9a-f]{8}  run=agent\d   CAS-attempts=\d+$",
         "  <commit>  run=agent<i>   CAS-attempts=<n>",
         "which agent publishes when, and so its commit id (salted by "
         "the commit counter) and its CAS attempts, follow the thread "
         "schedule; the normalizer keeps the six lines as a multiset"),
    ],
    "agent_swarm": [
        (r"^outcomes: \{.*\}$", "outcomes: <counts>",
         "how many of the 64 threads crash, commit or abort follows the "
         "schedule"),
        (r"^(faults injected: \d+ \(budget \d+\)): \[.*\]$", r"\1: <list>",
         "the order and the agents the seeded faults hit follow the "
         "schedule (the count, the budget's, stays)"),
        (r"^audit of \d+ published commits", "audit of <n> published "
         "commits", "the number of commits follows the outcomes"),
        (r"^\(\d+/\d+ commits carry manifests\)$",
         "(<n>/<m> commits carry manifests)",
         "which commits lose their manifest follows the crash faults"),
        (r"^janitor passes while agents ran: (\d+) \(\d+ branches",
         r"janitor passes while agents ran: \1 (<n> branches",
         "the branches a janitor pass finds follow the schedule"),
        (r"^branches left: \[.*\]$", "branches left: <list>",
         "the branches left follow the outcomes"),
        (r"^main tables: \d+$", "main tables: <n>",
         "the tables on main follow the outcomes"),
    ],
    "serve_pinned_commit": [
        (r"^(promotion: tagged serving/v2 ->) [0-9a-f]{10}$",
         r"\1 <commit>",
         "the commit id addresses the checkpoint's blobs, which each "
         "package encodes in its own tensor format"),
    ],
}

AUDIT_LINE = re.compile(
    r"^  [0-9a-f]{8}  swexample-64-a\d+r0 +(attempts=\d+ spans=\d+ "
    r"wrote=\[.*\]|\(no manifest: died after merge, before the audit "
    r"anchor\))$")


def _writers(lines: list) -> list:
    """concurrent_writers: the six agents' log lines as a sorted
    multiset; the fight's winner (fight0 or fight1, by the schedule)
    named by role, after checking that exactly one committed, the other
    aborted with its branch kept, and ``main`` holds the winner's
    value."""
    out, agents, fight = [], [], {}
    for line in lines:
        if line.startswith("  <commit>  run=agent"):
            agents.append(line)
            continue
        m = re.match(r"^fight(\d): (.*)$", line)
        if m:
            fight[m.group(1)] = m.group(2)
            continue
        m = re.match(r"^main hot='h(\d)'(.*)$", line)
        if m:
            won = [i for i, o in fight.items() if o == "committed"]
            lost = [i for i, o in fight.items() if o != "committed"]
            assert won == [m.group(1)] and len(lost) == 1, fight
            assert fight[lost[0]] == (f"aborted (branch txn/fight{lost[0]} "
                                      f"kept for triage)"), fight
            out += ["fight<winner>: committed",
                    "fight<loser>: aborted (branch txn/fight<loser> kept "
                    "for triage)", f"main hot='h<winner>'{m.group(2)}"]
            continue
        if agents and not line.startswith("  <commit>"):
            out += sorted(agents)
            agents = []
        out.append(line)
    return out


def _swarm(lines: list) -> list:
    """agent_swarm: each audit line has one of the two shapes; their
    number and order follow the schedule, so the block is one line."""
    out, n = [], 0
    for line in lines:
        if line.startswith("  ") and "swexample-64-" in line:
            assert AUDIT_LINE.match(line), line
            n += 1
            continue
        if n:
            out.append("<audit lines>")
            n = 0
        out.append(line)
    return out


NORMALIZE = {"concurrent_writers": _writers, "agent_swarm": _swarm}


def _masked(name: str, lines: list) -> list:
    out = []
    for line in lines:
        for pattern, repl, _reason in MASKS[name]:
            line = re.sub(pattern, repl, line)
        out.append(line)
    return NORMALIZE.get(name, lambda x: x)(out)


def _printed(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _root_main(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_root_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _port_main(name: str):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if name != "serve_pinned_commit":
        return lambda: mod.main(device="cpu")
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    params = params_from_jax(
        jax.tree.map(np.asarray,
                     JM.init_params(jax.random.PRNGKey(0),
                                    jax_smoke("phi4_mini_3b"))),
        get_smoke_config("phi4_mini_3b"))
    return lambda: mod.main(device="cpu", params=params)


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_prints_what_the_root_script_prints(name):
    want = _printed(_root_main(name))
    got = _printed(_port_main(name))
    assert want, name
    assert _masked(name, got) == _masked(name, want)


def test_every_mask_has_a_reason():
    assert sorted(MASKS) == sorted(EXAMPLES)
    for masks in MASKS.values():
        for pattern, _repl, reason in masks:
            re.compile(pattern)
            assert len(reason) > 10


@pytest.mark.parametrize("name", EXAMPLES)
def test_runs_on_the_card_unless_asked(name, monkeypatch):
    """With no device named, an entry point asks for ``cuda``: without
    a card it raises and runs nothing on the host."""
    import torch

    from repro_torch.exec import BackendUnavailable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(BackendUnavailable):
        mod.main()
