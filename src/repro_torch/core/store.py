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
exactly the paper's copy-on-write story. The blob layout is the same as
``repro``'s, so a store written by either package reads in the other.
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

from repro_torch.core.hooks import fault_point

__all__ = ["ObjectStore", "MemoryStore", "FileStore", "content_hash"]


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
        buf = io.BytesIO()
        buf.write(f"{dtype_name}\n".encode())
        np.save(buf, raw, allow_pickle=False)
        return self.put(buf.getvalue())

    def get_array(self, key: str) -> np.ndarray:
        buf = io.BytesIO(self.get(key))
        dtype_name = buf.readline().decode().strip()
        raw = np.load(buf, allow_pickle=False)
        if raw.dtype.name != dtype_name:
            import ml_dtypes  # bfloat16 and the other non-numpy dtypes
            raw = raw.view(np.dtype(getattr(ml_dtypes, dtype_name)))
        return raw


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
