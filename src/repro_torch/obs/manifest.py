"""Commit-anchored audit manifests (DESIGN.md §14).

A *run manifest* is the finished span tree of one transactional run,
serialized to a JSON document and stored in the same content-addressed
``ObjectStore`` the catalog commits live in. The anchoring rule: the
manifest is written under the named ref ``runmanifest/<commit_id>``
*after* the commit ref moves, keyed by the **published** commit id —
so any state an agent can observe in the catalog can be audited
post-hoc via :meth:`Catalog.run_manifest`, and an aborted run leaves
no manifest (there is no commit to anchor it to).

Manifests are observational, never load-bearing: nothing in commit
resolution, cache keys, or contract validation reads them back. A
missing manifest (run executed with tracing disabled) is a normal
state, reported as ``None``.
"""
from __future__ import annotations

from typing import Any

MANIFEST_REF_PREFIX = "runmanifest/"
MANIFEST_FORMAT = "repro_torch.run-manifest/1"

__all__ = ["MANIFEST_REF_PREFIX", "MANIFEST_FORMAT", "build_manifest",
           "store_manifest", "load_manifest"]


def build_manifest(run_span, spans, *, commit_id: str, run_id: str,
                   metrics: dict[str, Any] | None = None,
                   orphan_events: list[dict[str, Any]] | None = None,
                   ) -> dict[str, Any]:
    """Assemble the manifest document for one run.

    ``spans`` is the run's finished subtree (``recorder.subtree``), so
    concurrent runs sharing one recorder each serialize only their own
    spans — parent ids partition the forest.
    """
    return {
        "format": MANIFEST_FORMAT,
        "commit_id": commit_id,
        "run_id": run_id,
        "root_span_id": run_span.span_id,
        "spans": [s.to_dict() for s in spans],
        "metrics": metrics or {},
        "orphan_events": list(orphan_events or ()),
    }


def store_manifest(store, commit_id: str, doc: dict[str, Any]) -> str:
    """Persist ``doc`` content-addressed and anchor it to ``commit_id``.
    Returns the object key."""
    key = store.put_json(doc)
    store.put_ref(MANIFEST_REF_PREFIX + commit_id, key)
    return key


def load_manifest(store, commit_id: str) -> dict[str, Any] | None:
    """The manifest anchored to ``commit_id``, or None if the run was
    not traced (or the id is unknown)."""
    key = store.get_ref(MANIFEST_REF_PREFIX + commit_id)
    if key is None:
        return None
    return store.get_json(key)
