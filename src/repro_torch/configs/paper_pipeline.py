"""The paper's running example (Listings 1–5) as a reusable config.

``build_pipeline()`` returns the raw_table → parent → child → grand_child
DAG with the exact schemas of Listing 3; ``seed_lake(client)`` writes the
Listing-1 source table. Used by examples/quickstart.py and as the
canonical fixture for catalog/transaction demos.

NOTE: no ``from __future__ import annotations`` here — Schema class
bodies use live annotation objects (the paper's Listing-3 syntax).
"""
import datetime

import numpy as np

from repro_torch.core import schema as S
from repro_torch.core.contracts import CastDecl
from repro_torch.core.dag import Pipeline
from repro_torch.data.tables import Table, arrow_cast, col, lit, str_lit


class RawSchema(S.Schema):
    col1: str
    col2: datetime.datetime
    col3: int


class ParentSchema(S.Schema):          # "Node 1"
    col1: str
    col2: datetime.datetime
    _S: int


class ChildSchema(S.Schema):           # "Node 2"
    col2: datetime.datetime            # inherited type
    col4: float                        # fresh type
    col5: S.Nullable[str]              # fresh type (UNION(str, None))


class Grand(S.Schema):                 # "Node 3"
    col2: datetime.datetime            # inherited type
    col4: int                          # inherited type, narrowed


class FriendSchema(S.Schema):          # Appendix A, "Node 4"
    col2 = ChildSchema.col2
    col4 = Grand.col4
    col5 = ChildSchema.col5[S.NotNull]


def build_pipeline(*, with_friend: bool = False) -> Pipeline:
    p = Pipeline("paper_pipeline")
    p.source("raw_table", RawSchema)

    @p.node()   # parent_table: ParentSchema <- raw_table (Listing 4)
    def parent_table(df: RawSchema = "raw_table") -> ParentSchema:
        return df.group_by_sum(["col1", "col2"], "col3", out="_S")

    @p.node()   # "Node 1" -> "Node 2" (Listing 5)
    def child_table(df: ParentSchema = "parent_table") -> ChildSchema:
        return df.select([
            col("col2"),
            lit(0.25).alias("col4"),
            lit(None).alias("col5"),
        ])

    @p.node(casts=[CastDecl("col4", S.INT)])   # "Node 2" -> "Node 3"
    def grand_child(df: ChildSchema = child_table) -> Grand:
        return df.select([
            col("col2"),
            arrow_cast(col("col4"), str_lit("Int64")).alias("col4"),
        ])

    if with_friend:   # Appendix A binary node
        @p.node()
        def family_friend(df_child: ChildSchema = child_table,
                          df_grand: Grand = grand_child) -> FriendSchema:
            # Appendix A Listing 11: grand's col4 renamed before the join
            # so the joined table carries the INT version under "col4"
            dg = df_grand.select([col("col2"),
                                  col("col4").alias("4_grand")])
            j = df_child.filter(col("col5").is_not_null()) \
                .join(dg, on=["col2"])
            return j.select([col("col2"),
                             col("4_grand").alias("col4"),
                             col("col5")])

    return p


def seed_lake(client, rows: int = 5) -> None:
    """Write the Listing-1 ``raw_table`` source."""
    rng = np.random.default_rng(0)
    client.write_source_table("main", "raw_table", Table({
        "col1": np.array(list("ab" * rows)[:rows], dtype=object),
        "col2": np.array(["2026-07-01"] * rows, dtype="datetime64[ns]"),
        "col3": rng.integers(1, 10, rows).astype(np.int64),
    }))
