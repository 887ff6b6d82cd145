"""Carry a lake across: read what ``repro`` wrote into the port.

In a lakehouse the state is the lake: a store of content-addressed
column blobs and table snapshot manifests. The port keeps ``repro``'s
blob layout (``core/store.py``) and snapshot format (``Table.to_blobs``),
so it reads a lake that ``repro`` wrote as it is — no import of
``repro`` and no copy of the data. :func:`open_lake` opens a
``FileStore`` directory as the port's :class:`Catalog` with the given
tables committed on ``main``; :func:`tables_from_snapshots` loads
snapshots as the port's :class:`Table`\\ s. Fingerprints agree with
``repro``'s for the same snapshot.
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.core.catalog import Catalog
from repro_torch.core.store import FileStore, ObjectStore
from repro_torch.data.tables import Table

__all__ = ["open_lake", "tables_from_snapshots"]


def _check_snapshots(store: ObjectStore, keys: Mapping[str, str]) -> None:
    for name, key in keys.items():
        if key not in store:
            raise KeyError(f"table {name!r}: snapshot {key} is not in the "
                           f"store")
        if store.get_json(key).get("kind") != "table":
            raise ValueError(f"table {name!r}: {key} is not a table "
                             f"snapshot")


def tables_from_snapshots(store: ObjectStore,
                          keys: Mapping[str, str]) -> dict[str, Table]:
    """``{name: Table}`` for each ``{name: snapshot key}`` in ``store``."""
    _check_snapshots(store, keys)
    return {name: Table.from_blobs(store, key) for name, key in keys.items()}


def open_lake(root: str, tables: Mapping[str, str]) -> Catalog:
    """The port's catalog over the ``FileStore`` at ``root``, with
    ``tables`` (``{name: snapshot key}``, e.g. ``repro``'s
    ``catalog.tables("main")``) committed on ``main`` in one commit."""
    store = FileStore(root)
    _check_snapshots(store, tables)
    catalog = Catalog(store)
    if tables:
        catalog.write_tables("main", dict(tables), message="open lake")
    return catalog
