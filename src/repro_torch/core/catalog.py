"""Git-for-data catalog (paper §3.2 and §4).

Implements the Alloy model's signatures executably:

- a **Commit** is an immutable mapping ``{table -> snapshot}`` plus a
  parent set (merge commits have two parents) — "an immutable, unique
  reference to the state of all table snapshots at that moment";
- a **Branch** is a movable reference to the HEAD of a commit chain;
- a **Tag** is an immutable reference;
- ``create_table``/``write_table`` is the only state-changing operation:
  it allocates a fresh commit and advances the branch head (Listing 8);
- **merge** applies changes atomically from source to destination
  (three-way over the merge base, fast-forward when possible).

Branch heads move via optimistic compare-and-swap (the paper's substrate
guarantees this via a relational database; here a lock + expected-head
check), so concurrent writers conflict instead of silently interleaving.
Every head-moving operation (``write_table``/``write_tables``, ``merge``,
``rebase``) accepts ``expected_head``; a whole pipeline's outputs can be
committed as **one** multi-table atomic commit via :meth:`write_tables`,
and :meth:`rebase` replays a branch's table changes onto a new base so a
transactional run can re-verify exactly the state it is about to publish
(the rebase-and-revalidate protocol, DESIGN.md §7).

**Visibility classes** (the Fig. 4 guardrail — see DESIGN.md §6): branches
carry a :class:`Visibility`; transactional branches are system-owned;
*aborted* branches are readable but not mergeable, and branching off one
requires ``allow_reuse=True`` and yields a ``QUARANTINED`` branch that can
only be merged after explicit re-verification. This makes the Alloy
counterexample unrepresentable while preserving the paper's idempotent
re-run optimization.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import itertools
import threading
import time
from typing import Any, Callable, Iterator, Mapping, Sequence

from repro_torch.core.errors import (
    BranchExists,
    BranchNotFound,
    CatalogError,
    MergeConflict,
    RefConflict,
    VisibilityError,
)
from repro_torch.core.store import MemoryStore, ObjectStore

__all__ = ["Visibility", "Commit", "BranchInfo", "GCReport", "Catalog"]


class Visibility(enum.Enum):
    USER = "user"                # normal branch: read/write/merge
    TXN = "txn"                  # live transactional branch (system-owned)
    ABORTED = "aborted"          # failed txn branch: read-only, not mergeable
    QUARANTINED = "quarantined"  # reuse of an aborted branch: merge gated
    TAG = "tag"                  # immutable


@dataclasses.dataclass(frozen=True)
class Commit:
    """Immutable lake state: {table -> snapshot id} + parent commit ids."""

    id: str
    tables: Mapping[str, str]
    parents: tuple[str, ...]
    message: str = ""
    author: str = ""
    run_id: str | None = None
    timestamp: float = 0.0

    def snapshot_of(self, table: str) -> str | None:
        return self.tables.get(table)


@dataclasses.dataclass
class BranchInfo:
    name: str
    head: str
    visibility: Visibility = Visibility.USER
    owner_run: str | None = None   # for TXN branches: the owning run id
    verified: bool = False         # for QUARANTINED: re-verification flag
    updated_at: float = 0.0        # last head move / visibility change


@dataclasses.dataclass(frozen=True)
class GCReport:
    """What one :meth:`Catalog.gc` pass did (DESIGN.md §15).

    ``collected``/``kept`` list GC *candidates* (TXN and ABORTED
    branches) as ``(branch, reason)`` pairs; branches that are not
    candidates (USER, QUARANTINED, tags) appear in neither. Commits are
    never deleted — GC removes branch refs and observational
    ``runmanifest/`` store refs only, so a pinned commit's ancestry is
    intact by construction.
    """

    collected: tuple[tuple[str, str], ...] = ()
    kept: tuple[tuple[str, str], ...] = ()
    swept_manifests: tuple[str, ...] = ()   # commit ids unanchored
    swept_tmp: int = 0                      # leaked store temp files


def _commit_id(tables: Mapping[str, str], parents: tuple[str, ...],
               message: str, salt: str) -> str:
    h = hashlib.sha256()
    for t in sorted(tables):
        h.update(f"{t}={tables[t]};".encode())
    h.update(("|".join(parents) + "|" + message + "|" + salt).encode())
    return h.hexdigest()[:24]


class Catalog:
    """The versioning control plane. All public methods are atomic."""

    def __init__(self, store: ObjectStore | None = None,
                 main: str = "main"):
        self.store = store if store is not None else MemoryStore()
        self._lock = threading.RLock()
        self._commits: dict[str, Commit] = {}
        self._branches: dict[str, BranchInfo] = {}
        self._tags: dict[str, str] = {}
        self._counter = itertools.count()
        # The system starts with a single branch Main and a root commit
        # (Init) — paper Listing 7.
        root = Commit(id=_commit_id({}, (), "init", "0"), tables={},
                      parents=(), message="init", timestamp=time.time())
        self._commits[root.id] = root
        self._branches[main] = BranchInfo(name=main, head=root.id,
                                          updated_at=time.time())
        self.main = main
        self._pins: dict[str, int] = {}   # commit id -> pin count

    # ------------------------------------------------------------------
    # refs
    # ------------------------------------------------------------------
    def branch_info(self, name: str) -> BranchInfo:
        with self._lock:
            try:
                return dataclasses.replace(self._branches[name])
            except KeyError:
                raise BranchNotFound(f"branch {name!r} does not exist") \
                    from None

    def head(self, ref: str) -> Commit:
        """Resolve a ref (branch, tag, or commit id) to its Commit."""
        with self._lock:
            if ref in self._branches:
                return self._commits[self._branches[ref].head]
            if ref in self._tags:
                return self._commits[self._tags[ref]]
            if ref in self._commits:
                return self._commits[ref]
            raise BranchNotFound(f"unknown ref {ref!r}")

    def branches(self) -> list[str]:
        with self._lock:
            return sorted(self._branches)

    def run_manifest(self, ref: str) -> dict | None:
        """The audit manifest anchored to a published commit, or None.

        DESIGN.md §14: a traced :class:`~repro_torch.core.transactions.
        TransactionalRun` stores its finished span tree in this
        catalog's object store under ``runmanifest/<commit_id>`` at
        publication. ``ref`` may be any resolvable ref (branch, tag, or
        commit id); ``None`` means the commit exists but the run that
        produced it was not traced — a normal state, since tracing is
        opt-in and manifests are observational, never load-bearing.
        """
        from repro_torch.obs import load_manifest
        return load_manifest(self.store, self.head(ref).id)

    def commit(self, cid: str) -> Commit:
        with self._lock:
            try:
                return self._commits[cid]
            except KeyError:
                raise CatalogError(f"unknown commit {cid!r}") from None

    # ------------------------------------------------------------------
    # branch lifecycle
    # ------------------------------------------------------------------
    def create_branch(self, name: str, from_ref: str, *,
                      visibility: Visibility = Visibility.USER,
                      owner_run: str | None = None,
                      allow_reuse: bool = False) -> BranchInfo:
        """Zero-copy branch: only a new movable ref is created (paper §3.2).

        Branching off an ABORTED branch is refused unless
        ``allow_reuse=True``, in which case the new branch is QUARANTINED
        (the Fig. 4 guardrail).
        """
        with self._lock:
            if name in self._branches or name in self._tags:
                raise BranchExists(f"ref {name!r} already exists")
            src_vis = (self._branches[from_ref].visibility
                       if from_ref in self._branches else Visibility.USER)
            vis = visibility
            # ABORTED: the paper's Fig. 4 counterexample. TXN: a SECOND
            # counterexample our hypothesis search found (test_model_check):
            # branching from a LIVE transactional branch and merging
            # launders the uncommitted state of a still-running run into
            # main. Both require allow_reuse and yield QUARANTINED.
            if src_vis in (Visibility.ABORTED, Visibility.QUARANTINED,
                           Visibility.TXN) and vis is not Visibility.TXN:
                if not allow_reuse:
                    raise VisibilityError(
                        f"cannot branch from {src_vis.value} branch "
                        f"{from_ref!r} without allow_reuse=True "
                        f"(see DESIGN.md §6 / paper Fig. 4)")
                vis = Visibility.QUARANTINED
            head = self.head(from_ref)
            info = BranchInfo(name=name, head=head.id, visibility=vis,
                              owner_run=owner_run,
                              updated_at=time.time())
            self._branches[name] = info
            return dataclasses.replace(info)

    def delete_branch(self, name: str, *, _system: bool = False) -> None:
        """Delete a branch ref.

        Live transactional branches belong to their run, and aborted
        branches are preserved for triage (§3.3) — deleting either
        requires the owning system (``_system=True``).
        """
        with self._lock:
            if name == self.main:
                raise CatalogError("cannot delete the main branch")
            info = self._branches.get(name)
            if info is None:
                raise BranchNotFound(name)
            if not _system and info.visibility is Visibility.TXN:
                raise VisibilityError(
                    f"branch {name!r} is a live transactional branch owned "
                    f"by run {info.owner_run!r}: deleting it mid-run would "
                    f"strand the run")
            if not _system and info.visibility is Visibility.ABORTED:
                raise VisibilityError(
                    f"branch {name!r} is aborted and preserved for triage "
                    f"(§3.3); deletion requires the owning system")
            del self._branches[name]

    def tag(self, name: str, ref: str) -> str:
        with self._lock:
            if name in self._tags or name in self._branches:
                raise BranchExists(f"ref {name!r} already exists")
            cid = self.head(ref).id
            self._tags[name] = cid
            return cid

    def mark(self, name: str, visibility: Visibility, *,
             verified: bool | None = None, _system: bool = False) -> None:
        """Change a branch's visibility class.

        Two transitions are privileged (``_system=True``): any change to a
        live TXN branch (it is owned by its run), and un-marking an
        ABORTED branch (flipping it back to USER would let the Fig. 4
        laundering through the front door). The one user-facing
        transition is re-verifying a QUARANTINED branch
        (``verified=True``) — the sanctioned reuse path of DESIGN.md §6.
        """
        with self._lock:
            info = self._branches.get(name)
            if info is None:
                raise BranchNotFound(name)
            if not _system:
                if info.visibility is Visibility.TXN:
                    raise VisibilityError(
                        f"branch {name!r} is a live transactional branch "
                        f"owned by run {info.owner_run!r}: only the owning "
                        f"system may change its visibility")
                if (info.visibility is Visibility.ABORTED
                        and visibility is not Visibility.ABORTED):
                    raise VisibilityError(
                        f"branch {name!r} is aborted: un-marking it would "
                        f"republish a partial run (paper Fig. 4); use "
                        f"allow_reuse branching + re-verification instead")
                if (info.visibility is Visibility.QUARANTINED
                        and visibility is not Visibility.QUARANTINED
                        and not info.verified and not verified):
                    raise VisibilityError(
                        f"branch {name!r} is quarantined and unverified: "
                        f"re-verify first (mark(..., verified=True)) — "
                        f"releasing it to {visibility.value} would skip "
                        f"the merge gate")
            info.visibility = visibility
            if verified is not None:
                info.verified = verified
            info.updated_at = time.time()

    # ------------------------------------------------------------------
    # the only state-changing write (paper Listing 8)
    # ------------------------------------------------------------------
    def _writable_info(self, branch: str, expected_head: str | None,
                       _system: bool) -> BranchInfo:
        """Shared write guards: existence, visibility, optimistic CAS."""
        info = self._branches.get(branch)
        if info is None:
            raise BranchNotFound(branch)
        if info.visibility in (Visibility.ABORTED, Visibility.TAG):
            raise VisibilityError(
                f"branch {branch!r} is {info.visibility.value}: "
                f"read-only")
        if info.visibility is Visibility.TXN and not _system:
            raise VisibilityError(
                f"branch {branch!r} is a live transactional branch "
                f"owned by run {info.owner_run!r}")
        if expected_head is not None and info.head != expected_head:
            raise RefConflict(
                f"branch {branch!r} moved: expected {expected_head[:8]} "
                f"found {info.head[:8]}")
        return info

    def write_table(self, branch: str, table: str, snapshot: str, *,
                    message: str = "", author: str = "",
                    run_id: str | None = None,
                    expected_head: str | None = None,
                    _system: bool = False) -> Commit:
        """Commit a new snapshot of ``table`` and advance the branch head.

        Atomic w.r.t. concurrent writers: if ``expected_head`` is given and
        the branch has moved, raises :class:`RefConflict` (optimistic CAS —
        the paper's "optimistic locks guaranteed by a relational database").
        """
        return self.write_tables(
            branch, {table: snapshot}, message=message or f"write {table}",
            author=author, run_id=run_id, expected_head=expected_head,
            _system=_system)

    def write_tables(self, branch: str, tables: Mapping[str, str], *,
                     message: str = "", author: str = "",
                     run_id: str | None = None,
                     expected_head: str | None = None,
                     _system: bool = False) -> Commit:
        """Commit N table snapshots as ONE atomic commit.

        This is how a whole pipeline run publishes: all of the DAG's
        outputs land in a single commit, so ``log()`` reflects *runs*,
        not nodes, and readers can never observe a prefix of a run.
        An empty mapping is a no-op returning the current head.
        """
        with self._lock:
            info = self._writable_info(branch, expected_head, _system)
            parent = self._commits[info.head]
            if not tables:
                return parent
            merged = dict(parent.tables)
            merged.update(tables)
            cid = _commit_id(merged, (parent.id,), message,
                             str(next(self._counter)))
            commit = Commit(id=cid, tables=merged, parents=(parent.id,),
                            message=message or f"write {sorted(tables)}",
                            author=author, run_id=run_id,
                            timestamp=time.time())
            self._commits[cid] = commit
            info.head = cid
            info.updated_at = commit.timestamp
            return commit

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def read_table(self, ref: str, table: str) -> str:
        snap = self.head(ref).snapshot_of(table)
        if snap is None:
            raise CatalogError(f"table {table!r} not found at ref {ref!r}")
        return snap

    def read_tables(self, ref: str, tables: Sequence[str]
                    ) -> dict[str, str]:
        """Resolve several tables against ONE commit (a consistent
        multi-table snapshot read under a single lock acquisition) —
        how the engine pins a run's source set before scheduling waves.
        """
        with self._lock:
            head = self.head(ref)
        out: dict[str, str] = {}
        for t in tables:
            snap = head.snapshot_of(t)
            if snap is None:
                raise CatalogError(
                    f"table {t!r} not found at ref {ref!r}")
            out[t] = snap
        return out

    def tables(self, ref: str) -> Mapping[str, str]:
        return dict(self.head(ref).tables)

    def log(self, ref: str, limit: int = 50) -> list[Commit]:
        with self._lock:
            out, cur = [], self.head(ref)
            while cur is not None and len(out) < limit:
                out.append(cur)
                cur = (self._commits[cur.parents[0]] if cur.parents
                       else None)
            return out

    # ------------------------------------------------------------------
    # merge (paper §3.2/§3.3: logical, atomic)
    # ------------------------------------------------------------------
    def _ancestors(self, cid: str) -> set[str]:
        seen, stack = set(), [cid]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            stack.extend(self._commits[c].parents)
        return seen

    def merge_base(self, a: str, b: str) -> Commit:
        with self._lock:
            anc_a = self._ancestors(self.head(a).id)
            cur = [self.head(b).id]
            seen = set()
            while cur:
                nxt = []
                for cid in cur:
                    if cid in seen:
                        continue
                    seen.add(cid)
                    if cid in anc_a:
                        return self._commits[cid]
                    nxt.extend(self._commits[cid].parents)
                cur = nxt
        raise CatalogError(f"no common ancestor of {a!r} and {b!r}")

    def rebase(self, branch: str, onto: str, *,
               run_id: str | None = None,
               _system: bool = False) -> Commit:
        """Replay ``branch``'s table changes since the merge base onto
        ``onto``'s head, as ONE new commit; move the branch head to it.

        ``onto`` may be (and, for race-free publication, should be) a raw
        commit id — an immutable base, so the caller knows exactly which
        head the rebased state extends and can CAS its merge against it.
        Raises :class:`MergeConflict` when a table changed on both sides
        since the base. A branch with no changes fast-forwards.
        """
        with self._lock:
            info = self._writable_info(branch, None, _system)
            br_head = self._commits[info.head]
            onto_head = self.head(onto)
            base = self.merge_base(onto, branch)
            if br_head.id == onto_head.id or onto_head.id == base.id:
                return br_head            # already based on onto
            if br_head.id == base.id:
                info.head = onto_head.id  # no local changes: fast-forward
                info.updated_at = time.time()
                return onto_head
            changed_br = {t for t in set(br_head.tables) | set(base.tables)
                          if br_head.tables.get(t) != base.tables.get(t)}
            changed_onto = {
                t for t in set(onto_head.tables) | set(base.tables)
                if onto_head.tables.get(t) != base.tables.get(t)}
            conflicts = {
                t for t in changed_br & changed_onto
                if br_head.tables.get(t) != onto_head.tables.get(t)}
            if conflicts:
                raise MergeConflict(
                    f"cannot rebase {branch!r} onto {onto!r}: tables "
                    f"changed on both sides since base: {sorted(conflicts)}")
            tables = dict(onto_head.tables)
            for t in changed_br:
                if t in br_head.tables:
                    tables[t] = br_head.tables[t]
                else:
                    tables.pop(t, None)
            cid = _commit_id(tables, (onto_head.id,), br_head.message,
                             str(next(self._counter)))
            commit = Commit(
                id=cid, tables=tables, parents=(onto_head.id,),
                message=br_head.message or f"rebase {branch}",
                author=br_head.author, run_id=run_id or br_head.run_id,
                timestamp=time.time())
            self._commits[cid] = commit
            info.head = cid
            info.updated_at = commit.timestamp
            return commit

    def _is_published(self, cid: str) -> bool:
        """Is ``cid`` reachable from a mergeable (USER / verified-
        QUARANTINED) branch head?

        Only published commits may be merged by raw commit id or tag:
        anything else — an ABORTED/TXN-only commit, or one whose owning
        branch was deleted and survives only behind a tag — would
        launder unverified state past the visibility rules. One early-
        exiting walk over the union of good histories (no full-closure
        materialization under the lock).
        """
        seen: set[str] = set()
        stack = [info.head for info in self._branches.values()
                 if info.visibility is Visibility.USER
                 or (info.visibility is Visibility.QUARANTINED
                     and info.verified)]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            if c == cid:
                return True
            seen.add(c)
            stack.extend(self._commits[c].parents)
        return False

    def merge(self, source: str, into: str, *,
              message: str = "", run_id: str | None = None,
              expected_head: str | None = None,
              _system: bool = False) -> Commit:
        """Atomically apply changes from ``source`` to ``into``.

        Fast-forward when ``into`` has not moved since the merge base,
        else a three-way merge creating a two-parent commit; conflicting
        table updates (both sides changed the same table since base)
        raise :class:`MergeConflict`. Merging is purely logical — no
        snapshot (physical data) is copied.
        """
        with self._lock:
            src_info = self._branches.get(source)
            if src_info is None and not _system:
                # source is a raw commit id or a tag: the branch-level
                # visibility checks below cannot see it, so resolve the
                # commit's provenance instead (closes the laundering
                # hole where merging an ABORTED head by its commit id
                # republished a partial run).
                src_cid = self.head(source).id
                if not self._is_published(src_cid):
                    raise VisibilityError(
                        f"ref {source!r} resolves to commit "
                        f"{src_cid[:8]}, which is not reachable from "
                        f"any publishable branch: merging it would "
                        f"republish a partial, unverified run "
                        f"(paper Fig. 4)")
            if src_info is not None:
                if src_info.visibility is Visibility.ABORTED:
                    raise VisibilityError(
                        f"branch {source!r} was aborted by run "
                        f"{src_info.owner_run!r}: merging an aborted "
                        f"transactional branch would republish a partial "
                        f"run (paper Fig. 4)")
                if (src_info.visibility is Visibility.QUARANTINED
                        and not src_info.verified):
                    raise VisibilityError(
                        f"branch {source!r} is quarantined (built on an "
                        f"aborted run) and has not been re-verified")
                if src_info.visibility is Visibility.TXN and not _system:
                    raise VisibilityError(
                        f"branch {source!r} is a live transactional branch")
            dst_info = self._branches.get(into)
            if dst_info is None:
                raise BranchNotFound(into)
            if dst_info.visibility in (Visibility.ABORTED, Visibility.TAG):
                raise VisibilityError(f"branch {into!r} is read-only")
            if expected_head is not None and dst_info.head != expected_head:
                raise RefConflict(
                    f"branch {into!r} moved: expected {expected_head[:8]}")

            src_head = self.head(source)
            dst_head = self.head(into)
            base = self.merge_base(source, into)

            if src_head.id == base.id:
                return dst_head  # nothing to merge
            if dst_head.id == base.id:
                # fast-forward: move the ref (zero-copy)
                dst_info.head = src_head.id
                dst_info.updated_at = time.time()
                return src_head

            # three-way: detect table-level conflicts
            changed_src = {t for t in set(src_head.tables) | set(base.tables)
                           if src_head.tables.get(t) != base.tables.get(t)}
            changed_dst = {t for t in set(dst_head.tables) | set(base.tables)
                           if dst_head.tables.get(t) != base.tables.get(t)}
            conflicts = {
                t for t in changed_src & changed_dst
                if src_head.tables.get(t) != dst_head.tables.get(t)}
            if conflicts:
                raise MergeConflict(
                    f"tables changed on both branches since base: "
                    f"{sorted(conflicts)}")
            tables = dict(dst_head.tables)
            for t in changed_src:
                if t in src_head.tables:
                    tables[t] = src_head.tables[t]
                else:
                    tables.pop(t, None)
            cid = _commit_id(tables, (dst_head.id, src_head.id),
                             message, str(next(self._counter)))
            commit = Commit(
                id=cid, tables=tables, parents=(dst_head.id, src_head.id),
                message=message or f"merge {source} into {into}",
                run_id=run_id, timestamp=time.time())
            self._commits[cid] = commit
            dst_info.head = cid
            dst_info.updated_at = commit.timestamp
            return commit

    # ------------------------------------------------------------------
    # pinned readers (serve_pinned_commit + GC protection, DESIGN.md §15)
    # ------------------------------------------------------------------
    def pin(self, ref: str) -> str:
        """Pin the commit ``ref`` resolves to; returns its id.

        A pinned commit marks an active reader (a serving process, a
        triage investigation): GC keeps any candidate branch whose head
        is pinned and never unanchors the pinned commit's manifest.
        Commits themselves are immortal metadata — pinning guards the
        *refs* that make them discoverable. Refcounted: pin twice,
        unpin twice.
        """
        with self._lock:
            cid = self.head(ref).id
            self._pins[cid] = self._pins.get(cid, 0) + 1
            return cid

    def unpin(self, commit_id: str) -> None:
        with self._lock:
            n = self._pins.get(commit_id, 0)
            if n <= 1:
                self._pins.pop(commit_id, None)
            else:
                self._pins[commit_id] = n - 1

    def pinned(self) -> frozenset[str]:
        with self._lock:
            return frozenset(self._pins)

    # ------------------------------------------------------------------
    # quarantine release (DESIGN.md §6/§15: QUARANTINED -> re-verified
    # -> mergeable)
    # ------------------------------------------------------------------
    def release_quarantined(
            self, name: str,
            verifier: Callable[[Callable[[str], str]], Any]) -> Commit:
        """Re-verify a QUARANTINED branch and release it to USER.

        The sanctioned exit from quarantine: ``verifier(read)`` runs
        against the branch head captured at entry — ``read(table)``
        resolves snapshots at that *immutable commit*, not the live
        head — and the release CASes on the same head. If the branch
        moved during verification (the concurrent-reuse race on the
        Fig. 4 counterexample), :class:`RefConflict` is raised and the
        branch stays quarantined: no state is ever released that the
        verifier did not see. A verifier exception propagates and
        leaves the branch quarantined.
        """
        with self._lock:
            info = self._branches.get(name)
            if info is None:
                raise BranchNotFound(name)
            if info.visibility is not Visibility.QUARANTINED:
                raise VisibilityError(
                    f"branch {name!r} is {info.visibility.value}, not "
                    f"quarantined: nothing to release")
            head = self._commits[info.head]

        def read(table: str) -> str:
            snap = head.snapshot_of(table)
            if snap is None:
                raise CatalogError(
                    f"table {table!r} not found at quarantined head "
                    f"{head.id[:8]}")
            return snap

        verifier(read)   # outside the lock: may read data, take time

        with self._lock:
            info = self._branches.get(name)
            if info is None:
                raise BranchNotFound(
                    f"branch {name!r} was deleted during re-verification")
            if info.head != head.id:
                raise RefConflict(
                    f"branch {name!r} moved during re-verification: "
                    f"verified {head.id[:8]}, head is now "
                    f"{info.head[:8]} — re-verify the new state")
            info.verified = True
            info.visibility = Visibility.USER
            info.updated_at = time.time()
            return head

    # ------------------------------------------------------------------
    # branch garbage collection (DESIGN.md §15)
    # ------------------------------------------------------------------
    def gc(self, *, live_runs: Sequence[str] | frozenset[str] = (),
           grace_s: float = 0.0, now: float | None = None,
           sweep_manifests: bool = True, sweep_store_tmp: bool = True,
           dry_run: bool = False) -> GCReport:
        """Collect dead transactional debris so the catalog survives
        unbounded agent churn.

        Candidates and liveness rules (each kept branch carries its
        reason in the report):

        - **TXN** branches: kept while ``owner_run`` is in
          ``live_runs`` (the run still owns it — collecting it would
          strand a live publication) or younger than ``grace_s``
          (a run that exists but has not registered yet, or liveness
          information lagging the catalog). Otherwise the owner is
          dead — crashed or abandoned — and the branch is collected.
        - **ABORTED** branches: preserved for triage (§3.3), but not
          forever — collected after ``grace_s`` unless their head is
          pinned (a reader is actively triaging).
        - **QUARANTINED** branches: never collected. Unverified ones
          are awaiting re-verification (collecting would break the
          sanctioned reuse path); verified ones are user-domain.
        - **USER** branches and tags: never candidates.

        Commits are never deleted, so a pinned commit's ancestry — and
        every published commit — survives any GC schedule by
        construction. The ``runmanifest/`` sweep removes the
        observational audit-manifest refs of commits no longer
        reachable from any surviving branch, tag, or pin (safe by
        construction: nothing load-bearing reads manifests), and
        ``sweep_store_tmp`` collects temp files leaked by crashed
        :class:`~repro_torch.core.store.FileStore` writes.
        """
        t = time.time() if now is None else now
        collected: list[tuple[str, str]] = []
        kept: list[tuple[str, str]] = []
        with self._lock:
            # Snapshot liveness AFTER taking the lock: a run registers
            # itself live BEFORE its begin() creates the TXN branch
            # (which needs this lock), so every branch visible in the
            # scan below has an owner that had already registered when
            # this snapshot was taken — passing a live view (the swarm
            # janitor does) can never observe branch-without-owner.
            live = frozenset(live_runs)
            for name, info in list(self._branches.items()):
                if info.visibility is Visibility.TXN:
                    if info.owner_run is not None \
                            and info.owner_run in live:
                        kept.append((name, "live txn: owner run "
                                     f"{info.owner_run!r} is running"))
                        continue
                    if t - info.updated_at < grace_s:
                        kept.append((name, "txn within grace period"))
                        continue
                    if info.head in self._pins:
                        kept.append((name, "txn head pinned by reader"))
                        continue
                    collected.append(
                        (name, f"abandoned txn: owner run "
                               f"{info.owner_run!r} is not live"))
                elif info.visibility is Visibility.ABORTED:
                    if info.head in self._pins:
                        kept.append((name, "aborted head pinned "
                                           "(triage in progress)"))
                        continue
                    if t - info.updated_at < grace_s:
                        kept.append((name, "aborted within grace "
                                           "period (triage window)"))
                        continue
                    collected.append((name, "aborted past grace period"))
                elif info.visibility is Visibility.QUARANTINED:
                    kept.append((name,
                                 "quarantined awaiting re-verification"
                                 if not info.verified else
                                 "quarantined (re-verified, user-domain)"))
            if not dry_run:
                for name, _reason in collected:
                    del self._branches[name]
            # manifest sweep: reachability from every SURVIVING ref.
            # The ref listing happens UNDER the catalog lock: a
            # publication merges (moves a head, under this lock) before
            # it anchors its manifest, so any manifest ref visible here
            # belongs to a commit already in the reachability snapshot —
            # a racing publication's manifest can never be swept.
            swept: list[str] = []
            reachable: set[str] = set()
            manifest_refs: list[str] = []
            if sweep_manifests and not dry_run:
                stack = [i.head for i in self._branches.values()]
                stack += list(self._tags.values())
                stack += list(self._pins)
                while stack:
                    c = stack.pop()
                    if c in reachable:
                        continue
                    reachable.add(c)
                    stack.extend(self._commits[c].parents)
                from repro_torch.obs import MANIFEST_REF_PREFIX
                manifest_refs = list(
                    self.store.refs(MANIFEST_REF_PREFIX))
        swept_tmp = 0
        if not dry_run:
            from repro_torch.obs import MANIFEST_REF_PREFIX
            for ref in manifest_refs:
                cid = ref[len(MANIFEST_REF_PREFIX):]
                if cid not in reachable:
                    self.store.delete_ref(ref)
                    swept.append(cid)
            if sweep_store_tmp and hasattr(self.store, "sweep_tmp"):
                swept_tmp = self.store.sweep_tmp()
        return GCReport(collected=tuple(collected), kept=tuple(kept),
                        swept_manifests=tuple(swept),
                        swept_tmp=swept_tmp)

    # ------------------------------------------------------------------
    # introspection for tests / tooling
    # ------------------------------------------------------------------
    def diff(self, a: str, b: str) -> dict[str, tuple[str | None, str | None]]:
        """Table-level diff {table: (snap@a, snap@b)} where they differ.

        Both refs are resolved under one lock acquisition so the pair is
        a consistent snapshot even under concurrent writers.
        """
        with self._lock:
            ta, tb = self.tables(a), self.tables(b)
        out = {}
        for t in set(ta) | set(tb):
            if ta.get(t) != tb.get(t):
                out[t] = (ta.get(t), tb.get(t))
        return out

    def with_retry(self, fn: Callable[[], Any], *, attempts: int = 5,
                   backoff_s: float = 0.0) -> Any:
        """Retry an optimistic operation on :class:`RefConflict`."""
        last: Exception | None = None
        for _ in range(attempts):
            try:
                return fn()
            except RefConflict as e:
                last = e
                if backoff_s:
                    time.sleep(backoff_s)
        raise last  # type: ignore[misc]
