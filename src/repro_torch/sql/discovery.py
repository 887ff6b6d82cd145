"""Catalog table discovery: snapshot manifest -> inferred contract.

``Client.sql`` queries tables *at a pinned ref*; those tables may have
been written by ``write_source_table`` without any declared contract.
Discovery synthesizes one from the snapshot's manifest alone — the
``to_blobs`` manifest records each column's storage kind and numpy
dtype, so no column blob is ever loaded to type a query (compile stays
a control-plane moment even against terabyte tables).

Nullability is read off the manifest too: a ``valid`` key is present
iff the column genuinely contains NULLs (``_ColumnData`` normalizes
all-valid masks away before serialization), so discovered contracts
are exact for the snapshot they describe. The synthesized schema class
is named after the *table* (not the snapshot), keeping lineage strings
— and with them output-contract fingerprints and cache keys — stable
across commits that only change data.
"""
from __future__ import annotations

from repro_torch.core import schema as S
from repro_torch.data.tables import _NP_TO_LOGICAL
from repro_torch.sql.errors import SqlCompileError

__all__ = ["schema_from_snapshot"]


def schema_from_snapshot(store, snapshot: str,
                         table: str) -> type[S.Schema]:
    """Synthesize a :class:`~repro_torch.core.schema.Schema` for one table
    snapshot by reading only its manifest."""
    manifest = store.get_json(snapshot)
    if manifest.get("kind") != "table":
        raise SqlCompileError(
            f"snapshot {snapshot!r} of table {table!r} is not a "
            f"table manifest")
    cols: dict[str, S.Column] = {}
    for name, m in manifest["columns"].items():
        kind = m["kind"]
        if kind == "str":
            logical = "str"
        elif kind == "datetime":
            logical = "datetime"
        else:
            # "plain": numeric/bool — dtype recorded since the SQL
            # front door landed; fall back to loading the array for
            # snapshots written before that.
            np_name = m.get("dtype")
            if np_name is None:         # pragma: no cover - legacy
                np_name = str(store.get_array(m["values"]).dtype)
            logical = _NP_TO_LOGICAL.get(np_name)
            if logical is None:
                raise SqlCompileError(
                    f"table {table!r} column {name!r}: unmapped "
                    f"physical dtype {np_name!r}")
        cols[name] = S.Column(name, S.as_dtype(logical),
                              nullable=m["valid"] is not None)
    return S.Schema.of(table, **cols)
