"""Data-quality verifiers ("expectations") run inside transactional runs.

Paper §3.1: "Types also give Bauplan a principled handle on data quality
checks without additional tools" — verifiers are plain functions over the
transactional branch, run at step (3) of the §3.3 protocol. Any raise
aborts the run before publication.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.core.errors import QualityError
from repro_torch.data.tables import Table

__all__ = ["expect_not_null", "expect_unique", "expect_in_range",
           "expect_row_count", "expect_no_nan", "Verifier"]

Verifier = Callable[[Table], None]


def expect_not_null(column: str) -> Verifier:
    def check(t: Table) -> None:
        if t.has_nulls(column):
            raise QualityError(f"expectation failed: {column!r} has nulls")
    return check


def expect_unique(column: str) -> Verifier:
    def check(t: Table) -> None:
        vals = t.column(column)
        if len(np.unique(vals)) != len(vals):
            raise QualityError(
                f"expectation failed: {column!r} is not unique")
    return check


def expect_in_range(column: str, lo: float, hi: float) -> Verifier:
    def check(t: Table) -> None:
        vals = t.column(column)[t.validity(column)]
        if len(vals) and (vals.min() < lo or vals.max() > hi):
            raise QualityError(
                f"expectation failed: {column!r} not in [{lo}, {hi}] "
                f"(saw [{vals.min()}, {vals.max()}])")
    return check


def expect_row_count(lo: int, hi: int | None = None) -> Verifier:
    def check(t: Table) -> None:
        n = len(t)
        if n < lo or (hi is not None and n > hi):
            raise QualityError(
                f"expectation failed: row count {n} outside "
                f"[{lo}, {hi if hi is not None else 'inf'}]")
    return check


def expect_no_nan(column: str) -> Verifier:
    def check(t: Table) -> None:
        vals = t.column(column)
        if np.issubdtype(vals.dtype, np.floating) and np.isnan(vals).any():
            raise QualityError(f"expectation failed: {column!r} has NaNs")
    return check


def all_of(*verifiers: Verifier) -> Verifier:
    def check(t: Table) -> None:
        for v in verifiers:
            v(t)
    return check
