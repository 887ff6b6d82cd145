"""SQL front door (DESIGN.md §13): parse -> logical IR -> optimized plan.

A hand-written tokenizer + recursive-descent parser for single-SELECT
queries (joins, WHERE, GROUP BY aggregates, ORDER BY, LIMIT), an
AST-to-:mod:`repro_torch.core.logical` compiler with contract-inferred output
schemas, and catalog table discovery — so ``Client.sql(query, ref=...)``
and ``Pipeline.sql_query(name=..., query=...)`` are thin front ends
over the *existing* planner, optimizer, cache, and backends: every
query flows through ``optimize()``, executes on the stats-driven
``torch_auto`` backend, and caches content-addressed by its logical tree
(two spellings of one query share an entry; the query text is EXPLAIN
metadata, never key material).
"""
from repro_torch.sql.ast import Query
from repro_torch.sql.compiler import CompiledQuery, SqlNode, compile_query
from repro_torch.sql.discovery import schema_from_snapshot
from repro_torch.sql.errors import (SqlCompileError, SqlError, SqlParseError,
                              edit_distance, suggest)
from repro_torch.sql.parser import parse
from repro_torch.sql.tokens import Token, tokenize

__all__ = ["parse", "tokenize", "Token", "Query", "compile_query",
           "CompiledQuery", "SqlNode", "schema_from_snapshot",
           "SqlError", "SqlParseError", "SqlCompileError",
           "edit_distance", "suggest"]
