"""Core: the paper's contribution — contracts, versioning, transactions.

Public API re-exports for the composable surface used by examples, the
training framework, and tests.
"""
from repro_torch.core.catalog import Catalog, Commit, Visibility
from repro_torch.core.contracts import CastDecl, check_edge, check_node, validate_table
from repro_torch.core.dag import DeclarativeNode, Pipeline, PythonNode
from repro_torch.core.errors import (
    ContractAuthoringError, ContractCompositionError, ContractError,
    ContractRuntimeError, MergeConflict, Moment, PlanError, QualityError,
    RefConflict, ReproError, TransactionAborted, VisibilityError,
)
from repro_torch.core.planner import Plan, plan
from repro_torch.core.runner import Client, RunResult
from repro_torch.core.schema import (
    BOOL, DATETIME, FLOAT, FLOAT32, INT, INT32, INT64, STR, Nullable,
    NotNull, Schema, TensorContract,
)
from repro_torch.core.store import FileStore, MemoryStore, ObjectStore
from repro_torch.core.transactions import RunRegistry, RunState, TransactionalRun

__all__ = [k for k in dir() if not k.startswith("_")]
