"""Versioned, transactional checkpointing — the paper's §3.3 protocol
applied to model state.

The port of ``repro/checkpoints/checkpointing.py``. A checkpoint is a
*multi-table commit*: ``params``, ``opt_state``, ``data_state`` (pipeline
cursor) and ``metrics`` are published atomically — a restart that mixes
params@N with cursor@N−k is exactly the torn state of paper Fig. 3. The
manager writes all four artifacts inside one :class:`TransactionalRun`,
runs the finite-params check (the "data quality" gate), and merges
atomically. Tensors are copied to the host and stored leaf by leaf
(:func:`~repro_torch.core.store.put_pytree`), in ``repro``'s blob format.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.catalog import Catalog
from repro_torch.core.errors import QualityError
from repro_torch.core.store import (ObjectStore, get_pytree, put_pytree,
                                    tree_flatten)
from repro_torch.core.transactions import RunRegistry, TransactionalRun

TABLES = ("params", "opt_state", "data_state", "metrics")


@dataclasses.dataclass(frozen=True)
class CheckpointRef:
    step: int
    commit: str
    run_id: str


class CheckpointManager:
    def __init__(self, catalog: Catalog, *, branch: str = "main",
                 registry: RunRegistry | None = None,
                 check_finite: bool = True):
        self.catalog = catalog
        self.store: ObjectStore = catalog.store
        self.branch = branch
        self.registry = registry or RunRegistry()
        self.check_finite = check_finite

    # ------------------------------------------------------------------
    def save(self, *, step: int, params: Any, opt_state: Any,
             data_state: dict, metrics: dict,
             code: str = "") -> CheckpointRef:
        """Atomically publish a checkpoint (all four tables or none)."""
        with TransactionalRun(self.catalog, self.branch, code=code,
                              registry=self.registry,
                              run_id=f"ckpt_{step}") as txn:
            if self.check_finite:
                for leaf in tree_flatten(params)[0]:
                    if torch.is_tensor(leaf) and leaf.is_floating_point() \
                            and not bool(torch.isfinite(leaf).all()):
                        raise QualityError(
                            f"checkpoint step {step}: non-finite params")
            # all four artifacts in ONE commit: the branch log shows one
            # entry per checkpoint, and no reader can see a prefix.
            txn.write_tables({
                "params": put_pytree(self.store, params),
                "opt_state": put_pytree(self.store, opt_state),
                "data_state": self.store.put_json(
                    {"step": step, **data_state}),
                "metrics": self.store.put_json(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()}}),
            }, message=f"checkpoint@{step}")
        # the merged commit from the txn itself — NOT head(branch), which
        # may already reflect a later concurrent checkpoint.
        assert txn.final_commit is not None
        return CheckpointRef(step=step, commit=txn.final_commit.id,
                             run_id=f"ckpt_{step}")

    # ------------------------------------------------------------------
    def restore(self, like_params: Any, like_opt: Any, *,
                ref: str | None = None
                ) -> tuple[Any, Any, dict, dict] | None:
        """Load the latest checkpoint from ``ref`` (default: the branch)
        as CPU tensors.

        Guaranteed consistent: all four tables come from ONE commit."""
        ref = ref or self.branch
        head = self.catalog.head(ref)
        if "params" not in head.tables:
            return None
        params = get_pytree(self.store, head.tables["params"], like_params)
        opt = get_pytree(self.store, head.tables["opt_state"], like_opt)
        data_state = self.store.get_json(head.tables["data_state"])
        metrics = self.store.get_json(head.tables["metrics"])
        return params, opt, data_state, metrics

    def latest_step(self, ref: str | None = None) -> int | None:
        head = self.catalog.head(ref or self.branch)
        if "data_state" not in head.tables:
            return None
        return int(self.store.get_json(head.tables["data_state"])["step"])
