"""Hand-written tokenizer for the SQL front door (DESIGN.md §13).

Deliberately tiny: identifiers, keywords (case-insensitive), integer /
float / single-quoted string literals (with ``''`` escaping), the
operator set the expression grammar needs, and punctuation. Every token
records its character offset so parse errors can point at the query.
"""
from __future__ import annotations

import dataclasses

from repro_torch.sql.errors import SqlParseError

__all__ = ["Token", "tokenize", "KEYWORDS"]

KEYWORDS = frozenset({
    "SELECT", "FROM", "WHERE", "GROUP", "ORDER", "BY", "LIMIT",
    "JOIN", "INNER", "LEFT", "OUTER", "ON", "AS", "AND", "OR", "NOT",
    "IS", "NULL", "TRUE", "FALSE", "ASC", "DESC",
    "SUM", "COUNT", "MIN", "MAX", "MEAN", "AVG",
})

# longest-first so '<=' wins over '<', '<>' over '<'
_OPERATORS = ("<=", ">=", "<>", "!=", "==", "=", "<", ">",
              "+", "-", "*", "/")
_PUNCT = ("(", ")", ",", ".")


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str      # KEYWORD | IDENT | INT | FLOAT | STRING | OP | PUNCT | EOF
    text: str      # keyword text is uppercased; idents keep their case
    pos: int       # character offset into the query


def tokenize(query: str) -> list[Token]:
    out: list[Token] = []
    i, n = 0, len(query)
    while i < n:
        ch = query[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "'":
            j, chunks = i + 1, []
            while True:
                if j >= n:
                    raise SqlParseError(
                        f"unterminated string literal at position {i}")
                if query[j] == "'":
                    if j + 1 < n and query[j + 1] == "'":  # '' escape
                        chunks.append("'")
                        j += 2
                        continue
                    break
                chunks.append(query[j])
                j += 1
            out.append(Token("STRING", "".join(chunks), i))
            i = j + 1
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n
                            and query[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                c = query[j]
                if c.isdigit():
                    j += 1
                elif c == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif c in "eE" and not seen_exp and j > i:
                    seen_exp = True
                    j += 1
                    if j < n and query[j] in "+-":
                        j += 1
                else:
                    break
            text = query[i:j]
            kind = "FLOAT" if (seen_dot or seen_exp) else "INT"
            out.append(Token(kind, text, i))
            i = j
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (query[j].isalnum() or query[j] == "_"):
                j += 1
            text = query[i:j]
            if text.upper() in KEYWORDS:
                out.append(Token("KEYWORD", text.upper(), i))
            else:
                out.append(Token("IDENT", text, i))
            i = j
            continue
        for op in _OPERATORS:
            if query.startswith(op, i):
                out.append(Token("OP", op, i))
                i += len(op)
                break
        else:
            if ch in _PUNCT:
                out.append(Token("PUNCT", ch, i))
                i += 1
            else:
                raise SqlParseError(
                    f"unexpected character {ch!r} at position {i}")
    out.append(Token("EOF", "", n))
    return out
