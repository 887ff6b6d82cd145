"""Concurrent agents publishing group-by aggregates of one ``lineitem``.

    PYTHONPATH=src python -m repro_torch.examples.concurrent_runs \\
        [--sf 1] [--seed 0] [--device cuda]

The root ``examples/concurrent_writers.py`` (steps 1 and 3) and
``benchmarks/concurrent_publication.py::bench_rebase_reexecution``, at
TPC-H scale, through ``Client.run`` on the active backend (the port's
default, ``torch_auto`` on the card, sends a 6M-row group-by to the
segment kernels). Three scenarios, each on a fresh ``Client`` whose
``main`` holds the generated ``lineitem``:

- :func:`disjoint`: :data:`AGENTS` agents, one one-node pipeline each,
  started behind one barrier. Agent i groups ``lineitem`` by ``l_orderkey``
  (even i) or ``l_suppkey`` (odd i) and computes the SUM of
  ``l_quantity * (i + 1)``, COUNT, and MIN and MAX of
  ``l_extendedprice``. Each run's verifier waits once at a second
  barrier, so every run has executed before any publishes: all but one
  of them must rebase past the others, and each rebase must re-execute
  nothing (the inputs did not move; the node cache answers).
- :func:`same_table`: two agents write one table with different
  contents behind the same gate: exactly one commits, the other aborts
  with its branch kept, and ``main`` holds the winner's snapshot.
- :func:`crash_one`: :func:`disjoint` again under a fault plan that
  crashes the first run to reach ``txn.commit.pre_merge``: that run is
  invisible, the others commit, and ``Catalog.gc`` collects its branch.

Every published table must equal the same node run serially on the
port's ``vectorized`` backend, exactly (the nodes have no float SUM or
MEAN), and :func:`repro_torch.chaos.check_history` must find no
violation in the history, built from the run registry. A failed check
raises :class:`CheckFailed`. Each scenario takes those reference tables
from its caller (:func:`reference`, computed once).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from typing import Any, Sequence

import numpy as np

from repro_torch import exec as exec_backends
from repro_torch.chaos import (AgentRecord, FaultPlan, FaultRule,
                               InjectedCrash, check_history,
                               fault_injection)
from repro_torch.core import schema as S
from repro_torch.core.dag import Pipeline
from repro_torch.core.errors import TransactionAborted
from repro_torch.core.planner import plan
from repro_torch.core.runner import Client
from repro_torch.data.tables import Table, col, lit
from repro_torch.examples.tpch import generate

__all__ = ["AGENTS", "CheckFailed", "lineitem_with_suppkey", "agent_plan",
           "reference", "disjoint", "same_table", "crash_one"]

AGENTS = 8                       # as repro's bench_rebase_reexecution
SUPPLIERS_SF1 = 10_000           # TPC-H §4.2.3: S = SF * 10,000
PARTS_SF1 = 200_000
BARRIER_TIMEOUT_S = 600.0        # a broken run breaks the barrier sooner

Lines = S.Schema.of("Lines", l_orderkey="int64", l_suppkey="int64",
                    l_quantity="int64", l_extendedprice="float64")
Agg = S.Schema.of("Agg", key="int64", sum_qty="int64", n_lines="int64",
                  min_price="float64", max_price="float64")


class CheckFailed(AssertionError):
    """A check of a scenario failed."""


def _expect(cond, *what) -> None:
    if not cond:
        raise CheckFailed(" ".join(map(str, what)))


def lineitem_with_suppkey(sf: float, seed: int) -> dict[str, np.ndarray]:
    """``generate(sf, seed)``'s ``lineitem`` and an ``l_suppkey``
    column, drawn as TPC-H §4.2.3 draws it (one of the four suppliers of
    a random part), from its own stream of ``seed``: the generator has
    no supplier key."""
    li = dict(generate(sf, seed)["lineitem"])
    n = len(li["l_orderkey"])
    rng = np.random.default_rng([seed, 1])
    n_supp = max(4, round(SUPPLIERS_SF1 * sf))
    part = rng.integers(1, max(1, round(PARTS_SF1 * sf)) + 1, n)
    i = rng.integers(0, 4, n)
    li["l_suppkey"] = (part + i * (n_supp // 4 + (part - 1) // n_supp)) \
        % n_supp + 1
    return li


def agent_plan(i: int, table: str | None = None):
    """Agent ``i``'s one-node plan, writing ``table`` (``agg_i``)."""
    key = "l_orderkey" if i % 2 == 0 else "l_suppkey"
    scale = i + 1
    p = Pipeline(f"agent{i}")
    p.source("lineitem", Lines)

    @p.node(name=table or f"agg_{i}")
    def aggregate(li: Lines = "lineitem") -> Agg:
        rows = li.select([col(key).alias("key"),
                          (col("l_quantity") * lit(scale)).alias("qty"),
                          col("l_extendedprice")])
        return rows.group_by(["key"]).agg(
            ("sum", "qty", "sum_qty"), ("count", "qty", "n_lines"),
            ("min", "l_extendedprice", "min_price"),
            ("max", "l_extendedprice", "max_price"))

    return plan(p)


def fresh_client(lineitem: dict[str, np.ndarray]) -> Client:
    client = Client()
    client.write_source_table("main", "lineitem", Table(lineitem))
    return client


@dataclasses.dataclass
class Agents:
    """What each agent's ``Client.run`` ended with, by agent index: a
    ``RunResult``, or the exception it raised."""

    outcome: dict[int, Any]
    wall_s: float


def run_agents(client: Client, plans: Sequence, *,
               max_publish_attempts: int) -> Agents:
    """One thread per plan, started behind one barrier. Each run's
    verifier waits once at a second barrier, after its node ran and
    before it publishes, so no run publishes before every run has begun
    on the same ``main``: the interleaving is forced, not left to the
    scheduler."""
    k = len(plans)
    start = threading.Barrier(k, timeout=BARRIER_TIMEOUT_S)
    gate = threading.Barrier(k, timeout=BARRIER_TIMEOUT_S)
    outcome: dict[int, Any] = {}

    def worker(i: int) -> None:
        waited = []

        def at_gate(_table) -> None:
            if not waited:        # once: a rebase re-runs the verifier
                waited.append(True)
                gate.wait()

        try:
            start.wait()
            outcome[i] = client.run(
                plans[i], "main",
                verifiers={_output(plans[i]): [at_gate]},
                max_publish_attempts=max_publish_attempts)
        except BaseException as e:     # InjectedCrash is one
            outcome[i] = e
            if not waited:             # never reached the gate
                gate.abort()

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"agent-{i}") for i in range(k)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return Agents(outcome, time.perf_counter() - t0)


def _output(pl) -> str:
    (name,) = pl.output_tables
    return name


def history(client: Client, plans: Sequence, agents: Agents
            ) -> list[AgentRecord]:
    """``check_history``'s records, from the run registry's states: a
    run that raised ``InjectedCrash`` is the one the registry still
    holds as running."""
    cat, reg = client.catalog, client.registry
    running = [s for s in reg.runs() if s.status == "running"]
    crashed = [i for i, o in agents.outcome.items()
               if isinstance(o, InjectedCrash)]
    _expect(len(running) == len(crashed) <= 1,
            "runs left running", [s.run_id for s in running],
            "agents crashed", crashed)
    records = []
    for i, out in sorted(agents.outcome.items()):
        name = _output(plans[i])
        if isinstance(out, InjectedCrash):
            state, outcome = running[0], "crashed"
        elif isinstance(out, TransactionAborted):
            state = next(s for s in reg.runs() if s.txn_branch == out.branch)
            outcome = "aborted"
        elif isinstance(out, BaseException):
            raise CheckFailed(f"agent {i} raised {out!r}") from out
        else:
            state, outcome = out.state, out.state.status
        if outcome == "committed":
            tables = dict(out.tables)
        else:                  # what the run wrote, on its kept branch
            tables = {name: cat.tables(state.txn_branch)[name]}
        records.append(AgentRecord(
            agent=i, idx=0, run_id=state.run_id, intent="group_by",
            outcome=outcome, tables=tables, branch=state.txn_branch,
            final_commit=state.final_commit,
            verified_head=state.verified_head))
    return records


def reference(lineitem: dict[str, np.ndarray], plans: Sequence,
              backend="vectorized") -> dict[str, Table]:
    """Each plan run alone, one after another, on ``backend``."""
    client = fresh_client(lineitem)
    with exec_backends.use_backend(backend):
        for pl in plans:
            client.run(pl, "main")
    return {_output(pl): client.read_table("main", _output(pl))
            for pl in plans}


def same_columns(got: Table, want: Table, label: str) -> None:
    """Bit for bit: names, dtypes, values and validity."""
    _expect(got.column_names() == want.column_names(), label)
    _expect(got.num_rows == want.num_rows, label, got.num_rows,
            want.num_rows)
    for c in got.column_names():
        x, y = got.column(c), want.column(c)
        _expect(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
                label, c)
        _expect(np.array_equal(got.validity(c), want.validity(c)),
                label, c, "validity")


def _summary(client: Client, agents: Agents, committed: list) -> dict:
    """Wall seconds of the agents' threads, their CAS attempts (every
    run's, from the registry) and the committed runs' rebases."""
    k = len(agents.outcome)
    return {"agents": k, "committed": len(committed),
            "wall_s": agents.wall_s, "runs_per_s": k / agents.wall_s,
            "cas_attempts": sum(s.publish_attempts
                                for s in client.registry.runs()),
            "rebases": sum(len(r.rebase_reexecutions) for r in committed),
            "rebase_reexecutions": sum(sum(r.rebase_reexecutions)
                                       for r in committed)}


def _check_clean(client: Client, records) -> None:
    bad = check_history(client.catalog, records)
    _expect(not bad, "check_history:", bad)


def _run_disjoint(lineitem, want: dict[str, Table], label: str,
                  plan_faults: FaultPlan | None = None):
    client = fresh_client(lineitem)
    plans = [agent_plan(i) for i in range(AGENTS)]
    before = client.catalog.log("main", limit=1_000_000)
    if plan_faults is None:
        agents = run_agents(client, plans,
                            max_publish_attempts=4 * AGENTS)
    else:
        with fault_injection(plan_faults):
            agents = run_agents(client, plans,
                                max_publish_attempts=4 * AGENTS)
    records = history(client, plans, agents)
    committed = [o for o in agents.outcome.values()
                 if not isinstance(o, BaseException)]
    after = client.catalog.log("main", limit=1_000_000)
    new = after[:len(after) - len(before)]
    _expect(after[len(after) - len(before):] == before,
            label, "main's history was rewritten")
    _expect(len(new) == len(committed)
            and {c.run_id for c in new}
            == {r.state.run_id for r in committed},
            label, "main gained", len(new), "commits for",
            len(committed), "committed runs")
    summary = _summary(client, agents, committed)
    _expect(summary["rebase_reexecutions"] == 0, label,
            "rebases re-executed nodes", summary)
    # every run began on the same main, so all but the first to publish
    # conflicted at least once
    _expect(summary["rebases"] >= len(committed) - 1, label,
            "fewer rebases than the gate forces", summary)
    for r in records:
        if r.outcome == "committed":
            name = _output(plans[r.agent])
            same_columns(client.read_table("main", name), want[name],
                         f"{label} {name} vs vectorized")
    _check_clean(client, records)
    return client, plans, records, summary


def disjoint(lineitem: dict[str, np.ndarray], *,
             want: dict[str, Table]) -> dict:
    """Scenario (a). ``want``: :func:`reference`'s tables."""
    _, _, records, summary = _run_disjoint(lineitem, want, "disjoint")
    _expect(all(r.outcome == "committed" for r in records),
            "disjoint: a run did not commit",
            [(r.agent, r.outcome) for r in records])
    return summary


def same_table(lineitem: dict[str, np.ndarray], *,
               want: dict[str, Table]) -> dict:
    """Scenario (b): agents 1 and 3's nodes, both writing ``hot``.
    ``want``: :func:`reference`'s tables (agents 1 and 3's at least)."""
    agents_ = (1, 3)
    plans = [agent_plan(i, "hot") for i in agents_]
    client = fresh_client(lineitem)
    agents = run_agents(client, plans, max_publish_attempts=8)
    records = history(client, plans, agents)
    won = [r for r in records if r.outcome == "committed"]
    lost = [r for r in records if r.outcome == "aborted"]
    _expect(len(won) == 1 and len(lost) == 1, "same table: outcomes",
            [(r.agent, r.outcome) for r in records])
    (w,), (l,) = won, lost
    cat = client.catalog
    _expect(cat.read_table("main", "hot") == w.tables["hot"]
            and cat.head("main").id == w.final_commit,
            "same table: main does not hold the winner's snapshot")
    same_columns(client.read_table("main", "hot"),
                 want[f"agg_{agents_[w.agent]}"],
                 "same table: main's hot vs the winner's on vectorized")
    info = cat.branch_info(l.branch)
    _expect(info.visibility.value == "aborted", "same table: the loser's "
            "branch is", info.visibility)
    same_columns(client.read_table(l.branch, "hot"),
                 want[f"agg_{agents_[l.agent]}"],
                 "same table: the loser's kept branch")
    _check_clean(client, records)
    committed = [agents.outcome[w.agent]]
    return {**_summary(client, agents, committed),
            "winner": agents_[w.agent], "loser": agents_[l.agent]}


def crash_one(lineitem: dict[str, np.ndarray], *, seed: int,
              want: dict[str, Table]) -> dict:
    """Scenario (c): :func:`disjoint` with one run crashing at the CAS
    boundary, then the recovery sweep."""
    faults = FaultPlan(seed, [FaultRule("txn.commit.pre_merge", "crash")],
                       budget=1)
    client, plans, records, summary = _run_disjoint(
        lineitem, want, "crash", faults)
    crashed = [r for r in records if r.outcome == "crashed"]
    _expect(len(crashed) == 1 and faults.faults_injected == 1,
            "crash: runs crashed", [(r.agent, r.outcome) for r in records])
    _expect(sum(r.outcome == "committed" for r in records) == AGENTS - 1,
            "crash: the others did not all commit")
    (dead,) = crashed
    cat = client.catalog
    name, snap = next(iter(dead.tables.items()))
    _expect(all(c.tables.get(name) != snap
                for c in cat.log("main", limit=1_000_000)),
            "crash: the crashed run's table is on main")
    report = cat.gc(live_runs=(), grace_s=0.0)
    _expect(dead.branch not in cat.branches(),
            "crash: gc kept the crashed run's branch", report)
    for t in cat.tables("main"):
        client.read_table("main", t)
    _check_clean(client, records)
    return {**summary, "crashed": dead.agent, "crashed_run": dead.run_id,
            "collected": [n for n, _ in report.collected]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card, or cpu (default: cuda)")
    args = ap.parse_args(argv)
    from repro_torch.exec.torch_auto import TorchAutoBackend
    lineitem = lineitem_with_suppkey(args.sf, args.seed)
    want = reference(lineitem, [agent_plan(i) for i in range(AGENTS)])
    out = {}
    with exec_backends.use_backend(TorchAutoBackend(device=args.device)):
        out["disjoint"] = disjoint(lineitem, want=want)
        out["same_table"] = same_table(lineitem, want=want)
        out["crash"] = crash_one(lineitem, seed=args.seed, want=want)
    for name, summary in out.items():
        print(f"{name}: {json.dumps(summary)}")
    return out


if __name__ == "__main__":
    main()
