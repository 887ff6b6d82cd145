"""Quickstart: the paper's running example (Listings 1–6), end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds the raw_table -> parent -> child -> grand_child DAG with typed
contracts, runs it transactionally on a feature branch, reviews, merges.

The port of the root ``examples/quickstart.py``: its steps,
prints and asserts, on the card unless ``--device`` says otherwise
(``repro_torch.examples.entry``).
"""
import datetime

import numpy as np

from repro_torch.core import schema as S
from repro_torch.core.contracts import CastDecl
from repro_torch.core.dag import Pipeline
from repro_torch.core.errors import ContractCompositionError
from repro_torch.core.planner import plan
from repro_torch.core.quality import expect_not_null, expect_row_count
from repro_torch.core.runner import Client
from repro_torch.data.tables import Table, arrow_cast, col, lit, str_lit
from repro_torch.examples.entry import device_arg, on_device


# -- Listing 3: contracts as types ------------------------------------------

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
    col5: S.Nullable[str]              # fresh type, UNION(str, None)


class Grand(S.Schema):                 # "Node 3"
    col2: datetime.datetime            # inherited type
    col4: int                          # inherited type is narrowed


def run():
    # -- a lake with one source table ---------------------------------------
    client = Client()
    client.write_source_table("main", "raw_table", Table({
        "col1": np.array(["a", "a", "b", "b", "b"], dtype=object),
        "col2": np.array(["2026-07-01"] * 5, dtype="datetime64[ns]"),
        "col3": np.array([1, 2, 3, 4, 5], dtype=np.int64),
    }))

    # -- Listings 4–5: the typed DAG ----------------------------------------
    p = Pipeline("quickstart")
    p.source("raw_table", RawSchema)

    @p.node()   # parent_table: ParentSchema <- raw_table
    def parent_table(df: RawSchema = "raw_table") -> ParentSchema:
        return df.group_by_sum(["col1", "col2"], "col3", out="_S")

    @p.node()   # "Node 1" -> "Node 2"
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

    # -- moment 2: the control plane validates composition -------------------
    validated = plan(p)
    print(validated.describe())

    # schema failures are caught here, not at runtime:
    bad = Pipeline("bad")
    bad.source("raw_table", RawSchema)

    @bad.node()   # narrows col3 int->int32 with NO declared cast
    def broken(df: RawSchema = "raw_table") -> S.Schema.of("B",
                                                           col3=S.INT32):
        return df

    try:
        plan(bad)
    except ContractCompositionError as e:
        print(f"\n[control plane rejected ill-typed DAG] {e}\n")

    # -- Listing 6: branch, run transactionally, merge ------------------------
    client.create_branch("feature", from_ref="main")
    result = client.run(validated, "feature", verifiers={
        "parent_table": [expect_row_count(1, 100), expect_not_null("_S")],
    })
    st = result.state
    print(f"run {st.run_id}: {st.status} "
          f"(data commit {st.ref[:10]}, code {st.code_hash})")

    client.merge("feature", into="main")
    out = client.read_table("main", "grand_child")
    print("grand_child on main:", out.to_pydict())



def main(device: str = "cuda") -> None:
    """The walk-through, with ``torch_auto`` on ``device`` active."""
    with on_device(device):
        run()


if __name__ == "__main__":
    main(device_arg(__doc__))
