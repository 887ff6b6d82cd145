"""AST for the SQL front door — the parser's output, the compiler's input.

Plain frozen dataclasses, one per grammar production worth keeping.
Every node carries the ``pos`` of its first token so compile-time
errors (unknown column, type error) can point back into the query text.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ColumnRef", "Literal", "BinOp", "UnaryOp", "IsNull",
           "AggCall", "Star", "SelectItem", "TableRef", "JoinClause",
           "OrderItem", "Query"]


@dataclasses.dataclass(frozen=True)
class ColumnRef:
    table: str | None      # qualifier (alias or table name), or None
    name: str
    pos: int = 0

    def display(self) -> str:
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclasses.dataclass(frozen=True)
class Literal:
    value: Any             # int | float | str | bool | None
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class BinOp:
    op: str                # + - * / = != < <= > >= AND OR
    left: Any
    right: Any
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class UnaryOp:
    op: str                # NOT | -
    operand: Any
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class IsNull:
    operand: Any
    negated: bool          # True = IS NOT NULL
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class AggCall:
    fn: str                # sum | count | min | max | mean
    arg: Any               # expression AST
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class Star:
    table: str | None      # None = bare '*', else 'alias.*'
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Any              # expression AST or Star
    alias: str | None
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class TableRef:
    name: str
    alias: str | None
    pos: int = 0

    @property
    def binding(self) -> str:
        return self.alias or self.name


@dataclasses.dataclass(frozen=True)
class JoinClause:
    table: TableRef
    how: str                                    # "inner" | "left"
    on: tuple[tuple[ColumnRef, ColumnRef], ...]  # conjoined equalities
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class OrderItem:
    ref: ColumnRef
    ascending: bool
    pos: int = 0


@dataclasses.dataclass(frozen=True)
class Query:
    items: tuple[SelectItem, ...]
    from_table: TableRef
    joins: tuple[JoinClause, ...]
    where: Any | None
    group_by: tuple[ColumnRef, ...]
    order_by: tuple[OrderItem, ...]
    limit: int | None

    def table_names(self) -> list[str]:
        """Referenced physical table names, FROM first, in query order."""
        seen: list[str] = [self.from_table.name]
        for j in self.joins:
            if j.table.name not in seen:
                seen.append(j.table.name)
        return seen
