"""Linearizability / atomicity checker for swarm histories.

Generalizes the invariants of ``tests/test_concurrent_runs.py`` to the
full adversarial vocabulary of the swarm: crashes, abandons,
quarantine releases, and concurrent GC. All checks are on the *final*
catalog state plus the per-agent records — schedule-independent, so a
failing seed reproduces deterministically.

Invariants (DESIGN.md §15):

1.  **Readable catalog.** Every branch resolves; the target's
    first-parent history walks to the root; every commit's tables read.
2.  **Published = verified.** A committed run's ``final_commit`` is on
    the target's first-parent chain, appears there EXACTLY once, and
    equals the branch head its full verifier set validated.
3.  **All-or-nothing.** At its publication commit, ALL of a run's
    table snapshots are present; before it, NONE are — a reader at any
    commit sees either the whole run or none of it.
4.  **Aborted/abandoned runs are invisible.** No snapshot written by a
    run that did not publish appears anywhere on the chain — except
    snapshots re-legitimized by a quarantine release, which must be
    covered by a recorded re-verified release head.
5.  **Lost-ack crashes are still atomic.** A crashed run whose commit
    IS on the chain (died after merge, before acknowledging) is held
    to the committed-run rules; one that is not is held to invisible.
6.  **No mystery publications.** Every chain commit carrying a run_id
    belongs to a known record.
7.  **The Fig. 4 guardrail held.** No unverified quarantine merge
    succeeded, and no live branch was lost to GC mid-run.
"""
from __future__ import annotations

from typing import Iterable, Sequence

from repro_torch.core.catalog import Catalog, Commit

__all__ = ["check_history", "check_swarm"]


def _chain(catalog: Catalog, target: str) -> list[Commit]:
    """Target's first-parent history, root -> head."""
    log = catalog.log(target, limit=1_000_000)
    return list(reversed(log))


def check_history(catalog: Catalog, records: Sequence, *,
                  target: str = "main",
                  released_heads: Iterable[str] = ()) -> list[str]:
    """Return human-readable violations (empty list == history linearizable)."""
    v: list[str] = []

    # 1. catalog readable after everything (crashes, GC included)
    try:
        chain = _chain(catalog, target)
        if not chain or chain[0].parents:
            v.append(f"target {target!r} history does not reach the root")
    except Exception as e:   # noqa: BLE001 - any failure is the finding
        return [f"catalog unreadable: walking {target!r} raised {e!r}"]
    for b in catalog.branches():
        try:
            catalog.branch_info(b)
            catalog.tables(b)
        except Exception as e:   # noqa: BLE001
            v.append(f"branch {b!r} unreadable: {e!r}")

    by_run: dict[str, list[Commit]] = {}
    for c in chain:
        if c.run_id is not None:
            by_run.setdefault(c.run_id, []).append(c)

    # Quarantine releases re-legitimize the RE-VERIFIED branch state —
    # which includes its commit lineage: a released merge may
    # fast-forward the target onto commits originally authored by the
    # aborted run (the sanctioned Fig. 4 reuse path, DESIGN.md §6).
    # Everything reachable from a released head — commits and the
    # snapshots they expose — is therefore exempt from the
    # aborted-state-leak rules; aborted runs whose branches were NOT
    # released stay fully checked.
    released_ancestry: set[str] = set()
    stack = list(released_heads)
    while stack:
        cid = stack.pop()
        if cid in released_ancestry:
            continue
        released_ancestry.add(cid)
        stack.extend(catalog.commit(cid).parents)
    legit: set[tuple[str, str]] = set()
    for cid in released_ancestry:
        for t, s in catalog.commit(cid).tables.items():
            legit.add((t, s))

    index_of = {c.id: i for i, c in enumerate(chain)}
    known_runs = set()

    for r in records:
        rid = r.run_id
        known_runs.add(rid)
        on_chain = by_run.get(rid, [])
        published = r.outcome == "committed" or (
            r.outcome == "crashed" and on_chain)     # lost-ack
        if r.outcome == "committed" and not on_chain:
            v.append(f"{rid}: committed but no commit on {target!r}")
            continue
        if published:
            if len(on_chain) != 1:
                v.append(f"{rid}: {len(on_chain)} chain commits carry its "
                         f"run_id; publication must be exactly one")
                continue
            pub = on_chain[0]
            if r.final_commit is not None and r.final_commit != pub.id:
                v.append(f"{rid}: final_commit {r.final_commit[:8]} is not "
                         f"the chain commit {pub.id[:8]}")
            if r.outcome == "committed" and r.verified_head != pub.id:
                v.append(f"{rid}: published {pub.id[:8]} but verifiers "
                         f"validated {str(r.verified_head)[:8]} — "
                         f"unverified state reached {target!r}")
            missing = [t for t, s in r.tables.items()
                       if pub.tables.get(t) != s]
            if missing:
                v.append(f"{rid}: partial publication — {missing} absent "
                         f"from its own commit {pub.id[:8]}")
            horizon = index_of[pub.id]
            for c in chain[:horizon]:
                early = [t for t, s in r.tables.items()
                         if c.tables.get(t) == s]
                if early:
                    v.append(f"{rid}: snapshots {early} visible at "
                             f"{c.id[:8]} BEFORE publication "
                             f"{pub.id[:8]} (torn run)")
                    break
        else:
            # aborted / abandoned / crashed-unpublished / skipped:
            # nothing this run wrote may be visible, ever — unless a
            # quarantine release re-verified and republished it.
            rogue = [c for c in on_chain
                     if c.id not in released_ancestry]
            if rogue:
                v.append(f"{rid}: outcome {r.outcome!r} but commit(s) "
                         f"{[c.id[:8] for c in rogue]} are on "
                         f"{target!r}")
            for c in chain:
                leaked = [(t, s) for t, s in r.tables.items()
                          if c.tables.get(t) == s
                          and (t, s) not in legit]
                if leaked:
                    v.append(f"{rid}: outcome {r.outcome!r} but wrote "
                             f"{leaked} visible at {c.id[:8]} "
                             f"(aborted state leaked)")
                    break
        if getattr(r, "illegal_merge", False):
            v.append(f"{rid}: UNVERIFIED quarantined branch merged into "
                     f"{target!r} (paper Fig. 4 guardrail failed)")
        if r.outcome == "branch_lost":
            v.append(f"{rid}: live branch vanished mid-run ({r.error}) — "
                     f"GC collected live state")

    for c in chain:
        if c.run_id is not None and c.run_id not in known_runs:
            v.append(f"chain commit {c.id[:8]} carries unknown run_id "
                     f"{c.run_id!r} (mystery publication)")
    return v


def check_swarm(result) -> list[str]:
    """Check a :class:`~repro_torch.chaos.swarm.SwarmResult` end to end."""
    return check_history(result.catalog, result.records,
                         target=result.config.target,
                         released_heads=result.released_heads)
