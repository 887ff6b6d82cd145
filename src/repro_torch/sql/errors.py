"""SQL front-door errors (control-plane moment, like every PlanError).

Both error classes subclass :class:`repro_torch.core.errors.PlanError`: a
query that fails to parse or compile is an ill-typed pipeline, rejected
before any worker touches data ("ill-typed pipelines should not be
planned"). Unknown-name errors carry an edit-distance suggestion — the
one piece of UX the paper's agent story actually needs, because an
agent retries from the error text alone.

Message formats are pinned by tests (tests/test_sql_compiler.py); keep
them stable::

    unknown table 'userz' at ref 'main' (commit ab12...); did you mean
    'users'? known tables: ['orders', 'users']
    unknown column 'amout' in table 'orders' at ...; did you mean
    'amount'?
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.errors import PlanError

__all__ = ["SqlError", "SqlParseError", "SqlCompileError",
           "edit_distance", "suggest", "unknown_name"]

# a suggestion further than this many edits away is noise, not help
_MAX_SUGGEST_DISTANCE = 3


class SqlError(PlanError):
    """Base of all SQL front-door errors."""


class SqlParseError(SqlError):
    """The query text does not match the grammar (DESIGN.md §13)."""


class SqlCompileError(SqlError):
    """The query parsed but does not compile against the catalog/
    pipeline schemas (unknown names, type errors, shape violations)."""


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (insert/delete/substitute, unit costs).

    Hand-rolled O(len(a)*len(b)) DP over two rows — names are short, so
    no banding needed; case-insensitive (SQL identifiers are)."""
    a, b = a.lower(), b.lower()
    if a == b:
        return 0
    if not a or not b:
        return len(a) + len(b)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i]
        for j, cb in enumerate(b, start=1):
            cur.append(min(prev[j] + 1,          # delete from a
                           cur[j - 1] + 1,       # insert into a
                           prev[j - 1] + (ca != cb)))  # substitute
        prev = cur
    return prev[-1]


def suggest(name: str, candidates: Sequence[str]) -> str | None:
    """Nearest candidate within the suggestion radius, or None.

    Ties break lexicographically so the message is deterministic."""
    best: str | None = None
    best_d = _MAX_SUGGEST_DISTANCE + 1
    for cand in sorted(candidates):
        d = edit_distance(name, cand)
        if d < best_d:
            best, best_d = cand, d
    return best


def unknown_name(kind: str, name: str, candidates: Sequence[str],
                 context: str, *, where: str = "",
                 list_known: bool = False) -> SqlCompileError:
    """Build the pinned unknown-table/column error message."""
    msg = f"unknown {kind} {name!r}{where} at {context}"
    hint = suggest(name, candidates)
    if hint is not None:
        msg += f"; did you mean {hint!r}?"
    if list_known:
        msg += f" known {kind}s: {sorted(candidates)}"
    return SqlCompileError(msg)
