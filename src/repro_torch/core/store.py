"""Content-addressed immutable object store (paper §3.2, physical layer).

The paper's physical substrate is parquet + snapshot files immutably
stored in object storage; branching and merging are purely *logical*
(zero-copy). We reproduce that split: this module stores immutable,
content-addressed blobs; :mod:`repro_torch.core.catalog` stores only references.

Two backends:

- :class:`MemoryStore` — in-process dict, used by tests and the planner.
- :class:`FileStore`   — a directory of ``objects/<aa>/<hash>`` files with
  atomic single-blob put (write-temp + rename), the "S3 put" the paper
  assumes. Used by checkpointing so restarts survive process death.

Table snapshots go in as one raw array blob per column plus a JSON
manifest, so two snapshots sharing columns share physical blobs, which is
exactly the paper's copy-on-write story. Model state goes in the same
way through :func:`put_pytree`: one tensor blob per leaf and a manifest.
The blob layout is the same as ``repro``'s, so a store written by either
package reads in the other. bfloat16, which numpy lacks, is stored as
its raw bits under a one-line dtype header, as ``repro`` stores it; the
port reads such a blob back as a torch tensor
(:meth:`ObjectStore.get_tensor`) and never needs ``ml_dtypes``. A
bfloat16 table column comes back as its bits under the port's tagged
dtype (:meth:`ObjectStore.get_column`, :mod:`repro_torch.data.bfloat16`).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import threading
import time
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from repro_torch.core.hooks import fault_point
from repro_torch.data import bfloat16

__all__ = ["ObjectStore", "MemoryStore", "FileStore", "put_pytree",
           "get_pytree", "get_pytree_leaves", "tree_flatten",
           "tree_unflatten", "content_hash"]

# dtypes numpy lacks: their blobs hold the raw bits, as unsigned ints of
# the same width, under the dtype's name
_RAW_DTYPES = {"bfloat16": torch.bfloat16}
_RAW_NAMES = {v: k for k, v in _RAW_DTYPES.items()}


def content_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class ObjectStore:
    """Abstract immutable blob store keyed by content hash.

    Besides immutable blobs, a store exposes a small *named-ref* surface
    (``put_ref``/``get_ref``): mutable name → blob-key pointers, the
    only mutable state in the physical layer. The engine's
    content-addressed function cache persists through it (a cache entry
    is ``fncache/<cache-key> -> output snapshot key``), so a
    :class:`FileStore`-backed cache survives process restarts.
    """

    def put(self, data: bytes) -> str:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self) -> Iterator[str]:
        raise NotImplementedError

    # -- named refs (mutable pointers into the immutable blob space) ---
    def put_ref(self, name: str, key: str) -> None:
        raise NotImplementedError

    def get_ref(self, name: str) -> str | None:
        raise NotImplementedError

    def refs(self, prefix: str = "") -> Iterator[str]:
        """Iterate ref names (optionally under ``prefix``) — the
        enumeration surface ``Catalog.gc``'s manifest sweep walks."""
        raise NotImplementedError

    def delete_ref(self, name: str) -> bool:
        """Remove a named ref; returns whether it existed. The blob it
        pointed at stays (immutable space; content GC is out of scope)."""
        raise NotImplementedError

    # -- structured helpers -------------------------------------------
    def put_json(self, obj: Any) -> str:
        return self.put(json.dumps(obj, sort_keys=True).encode())

    def get_json(self, key: str) -> Any:
        return json.loads(self.get(key).decode())

    def put_array(self, arr) -> str:
        arr = np.asarray(arr)
        if bfloat16.is_bfloat16(arr.dtype):
            return self._put_blob("bfloat16", bfloat16.bits(arr))
        # ml_dtypes (bfloat16 etc.) are not .npy-native: store the raw
        # bits viewed as uint and a one-line dtype header.
        dtype_name = arr.dtype.name
        if arr.dtype.kind not in ("U", "S") and (
                arr.dtype.kind == "V" or dtype_name not in np.sctypeDict):
            raw = arr.view(np.uint8 if arr.dtype.itemsize == 1 else
                           np.uint16 if arr.dtype.itemsize == 2 else
                           np.uint32)
        else:
            raw = arr
        return self._put_blob(dtype_name, raw)

    def _put_blob(self, dtype_name: str, raw: np.ndarray) -> str:
        buf = io.BytesIO()
        buf.write(f"{dtype_name}\n".encode())
        np.save(buf, raw, allow_pickle=False)
        return self.put(buf.getvalue())

    def _get_blob(self, key: str) -> tuple[str, np.ndarray]:
        buf = io.BytesIO(self.get(key))
        dtype_name = buf.readline().decode().strip()
        return dtype_name, np.load(buf, allow_pickle=False)

    def get_array(self, key: str) -> np.ndarray:
        dtype_name, raw = self._get_blob(key)
        if raw.dtype.name != dtype_name:
            raise TypeError(
                f"blob {key[:12]} holds {dtype_name}, which numpy lacks: "
                f"read it as a torch tensor with get_tensor, or as a "
                f"table column with get_column")
        return raw

    def get_column(self, key: str) -> np.ndarray:
        """A table column: :meth:`get_array`, and for a bfloat16 blob
        its bits under :data:`repro_torch.data.bfloat16.BFLOAT16`."""
        dtype_name, raw = self._get_blob(key)
        if dtype_name == "bfloat16" and raw.dtype == np.uint16:
            return bfloat16.from_bits(raw)
        return self.get_array(key)

    def put_tensor(self, t: torch.Tensor) -> str:
        """Store a tensor (moved to the host) as the same bytes ``repro``
        writes for the equal numpy array."""
        t = t.detach().cpu().contiguous()
        name = _RAW_NAMES.get(t.dtype)
        if name is None:
            return self.put_array(t.numpy())
        return self._put_blob(name, t.view(torch.uint16).numpy())

    def get_tensor(self, key: str) -> torch.Tensor:
        """A numeric blob as a CPU tensor; a bfloat16 blob comes back
        through a view of its raw bits."""
        dtype_name, raw = self._get_blob(key)
        if raw.dtype.name == dtype_name:
            if raw.dtype.kind in ("U", "S", "O"):
                raise TypeError(f"blob {key[:12]} holds {dtype_name}, "
                                f"not numbers")
            return torch.from_numpy(raw)
        dtype = _RAW_DTYPES.get(dtype_name)
        if dtype is None:
            raise TypeError(f"blob {key[:12]}: unknown dtype {dtype_name}")
        return torch.from_numpy(raw).view(dtype)


class MemoryStore(ObjectStore):
    """Thread-safe: concurrent transactional runs share one store, so
    every dict access goes through the lock."""

    def __init__(self):
        self._blobs: dict[str, bytes] = {}
        self._refs: dict[str, str] = {}
        self._lock = threading.Lock()

    def put(self, data: bytes) -> str:
        key = content_hash(data)
        with self._lock:
            # immutable: put of existing key is a no-op (dedup)
            self._blobs.setdefault(key, bytes(data))
        return key

    def get(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._blobs[key]
            except KeyError:
                raise KeyError(f"object {key!r} not in store") from None

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    def keys(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._blobs))

    def put_ref(self, name: str, key: str) -> None:
        with self._lock:
            self._refs[name] = key

    def get_ref(self, name: str) -> str | None:
        with self._lock:
            return self._refs.get(name)

    def refs(self, prefix: str = "") -> Iterator[str]:
        with self._lock:
            return iter([n for n in self._refs if n.startswith(prefix)])

    def delete_ref(self, name: str) -> bool:
        with self._lock:
            return self._refs.pop(name, None) is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)


class FileStore(ObjectStore):
    """Filesystem-backed store with atomic single-blob put.

    Layout: ``<root>/objects/<first2>/<hash>``. Put is write-to-temp then
    ``os.replace`` (atomic on POSIX) — the single-object atomicity the
    paper assumes of S3/Iceberg and builds on top of.

    **Crash consistency** (DESIGN.md §15): temp files are dot-prefixed
    (``.tmp-*``) so a crash between write and replace can never be
    mistaken for an object or a ref — ``keys()``/``refs()``/``get_ref``
    skip them by construction (ref-name validation already rejects
    dot-leading components). Cleanup of an *errored* write runs on
    ``Exception`` only: an :class:`~repro_torch.core.hooks.InjectedCrash`
    (``BaseException``, simulated process death) leaks the temp file
    exactly as a killed process would, and :meth:`sweep_tmp` is the
    GC that recovers the leak.
    """

    _TMP_PREFIX = ".tmp-"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "objects"), exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, "objects", key[:2], key)

    def put(self, data: bytes) -> str:
        key = content_hash(data)
        path = self._path(key)
        if os.path.exists(path):
            return key  # dedup
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=self._TMP_PREFIX)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            fault_point("filestore.put.pre_replace", tmp=tmp, path=path,
                        key=key)
            os.replace(tmp, path)  # atomic publish
        except Exception:
            # recoverable error: clean our temp. A crash (BaseException)
            # skips this, leaking the temp like real process death —
            # sweep_tmp() collects it.
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return key

    def get(self, key: str) -> bytes:
        path = self._path(key)
        if not os.path.exists(path):
            raise KeyError(f"object {key!r} not in store")
        with open(path, "rb") as f:
            return f.read()

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def keys(self) -> Iterator[str]:
        objdir = os.path.join(self.root, "objects")
        for d in os.listdir(objdir):
            sub = os.path.join(objdir, d)
            if not os.path.isdir(sub):
                continue
            for k in os.listdir(sub):
                if not k.startswith("."):   # leaked .tmp-* are not keys
                    yield k

    def _ref_path(self, name: str) -> str:
        parts = name.split("/")
        if not all(p and all(c.isalnum() or c in "._-" for c in p)
                   and not p.startswith(".") for p in parts):
            raise ValueError(f"invalid ref name {name!r}")
        return os.path.join(self.root, "refs", *parts)

    def put_ref(self, name: str, key: str) -> None:
        path = self._ref_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=self._TMP_PREFIX)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(key)
            # the torn-write window a naive open(path,"w").write() would
            # have: a crash here leaves the OLD ref intact (the temp is
            # invisible to readers) — regression-tested crash-at-every-
            # byte in tests/test_chaos_faults.py.
            fault_point("filestore.put_ref.pre_replace", tmp=tmp,
                        path=path, name=name, key=key)
            os.replace(tmp, path)  # atomic, like blob put
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get_ref(self, name: str) -> str | None:
        path = self._ref_path(name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read().strip()

    def refs(self, prefix: str = "") -> Iterator[str]:
        refdir = os.path.join(self.root, "refs")
        if not os.path.isdir(refdir):
            return
        for dirpath, _dirs, files in os.walk(refdir):
            rel = os.path.relpath(dirpath, refdir)
            for fn in files:
                if fn.startswith("."):      # leaked temp, not a ref
                    continue
                name = fn if rel == "." else "/".join(
                    rel.split(os.sep) + [fn])
                if name.startswith(prefix):
                    yield name

    def delete_ref(self, name: str) -> bool:
        path = self._ref_path(name)
        if not os.path.exists(path):
            return False
        os.unlink(path)
        return True

    def sweep_tmp(self, min_age_s: float = 0.0) -> int:
        """GC leaked ``.tmp-*`` files (crashed writes). ``min_age_s``
        guards in-flight writers by mtime; returns files removed."""
        removed = 0
        now = time.time()
        for top in ("objects", "refs"):
            base = os.path.join(self.root, top)
            if not os.path.isdir(base):
                continue
            for dirpath, _dirs, files in os.walk(base):
                for fn in files:
                    if not fn.startswith(self._TMP_PREFIX):
                        continue
                    p = os.path.join(dirpath, fn)
                    try:
                        if now - os.path.getmtime(p) >= min_age_s:
                            os.unlink(p)
                            removed += 1
                    except OSError:  # pragma: no cover - racing writer
                        pass
        return removed


# ---------------------------------------------------------------------------
# Pytree snapshots (copy-on-write structured artifacts)
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Any) -> tuple[list, str]:
    """Leaves in ``repro``'s order (dict keys sorted, lists, tuples and
    NamedTuple fields in order; ``None`` holds no leaf) and the port's
    structure string of the tree."""
    leaves: list = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return type(x).__name__ + "(" + ", ".join(
                f"{f}={walk(v)}" for f, v in zip(x._fields, x)) + ")"
        if isinstance(x, (list, tuple)):
            inner = ", ".join(walk(v) for v in x)
            return f"[{inner}]" if isinstance(x, list) else f"({inner},)"
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`tree_flatten`'s order) in the structure of
    ``like``."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}
        if _is_namedtuple(x):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)

    tree = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return tree


def put_pytree(store: ObjectStore, tree: Any) -> str:
    """Store a tree of tensors (or numpy arrays); returns the manifest key
    (the snapshot id).

    Leaves are stored as individual blobs, so snapshots that share leaves
    share storage — logical copies are zero-copy, as in the paper.
    """
    leaves, structure = tree_flatten(tree)
    leaf_keys = [store.put_tensor(x) if isinstance(x, torch.Tensor)
                 else store.put_array(x) for x in leaves]
    manifest = {"treedef": structure, "leaves": leaf_keys, "kind": "pytree"}
    return store.put_json(manifest)


def get_pytree(store: ObjectStore, key: str, like: Any) -> Any:
    """Load a snapshot that :func:`put_pytree` wrote as CPU tensors;
    ``like`` provides the tree structure."""
    manifest = store.get_json(key)
    _, structure = tree_flatten(like)
    if structure != manifest["treedef"]:
        raise ValueError(
            "snapshot treedef mismatch: stored structure differs from "
            "`like` structure (a snapshot that repro wrote reads through "
            "get_pytree_leaves)")
    return tree_unflatten(like, get_pytree_leaves(store, key))


def get_pytree_leaves(store: ObjectStore, key: str) -> list[torch.Tensor]:
    """The leaves of a pytree snapshot, in order, as CPU tensors: also
    reads a snapshot that ``repro`` wrote, whose structure string is
    JAX's."""
    manifest = store.get_json(key)
    return [store.get_tensor(k) for k in manifest["leaves"]]
