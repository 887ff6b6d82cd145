"""Carry a lake across: read what ``repro`` wrote into the port.

In a lakehouse the state is the lake: a store of content-addressed
column blobs and table snapshot manifests. The port keeps ``repro``'s
blob layout (``core/store.py``) and snapshot format (``Table.to_blobs``),
so it reads a lake that ``repro`` wrote as it is — no import of
``repro`` and no copy of the data. :func:`open_lake` opens a
``FileStore`` directory as the port's :class:`Catalog` with the given
tables committed on ``main``; :func:`tables_from_snapshots` loads
snapshots as the port's :class:`Table`\\ s. Fingerprints agree with
``repro``'s for the same snapshot.

Model parameters cross the same way. :func:`params_from_jax` turns
``repro``'s parameter tree (numpy arrays, or the tensors of a snapshot)
into the port's ``state_dict``: ``repro`` stacks the layers of each
position of the block pattern (``slots``) and keeps the remainder layers
apart (``tail``); the port has one entry per layer, in order.
:func:`params_from_store` does the same for a parameter snapshot that
``repro``'s ``CheckpointManager`` published, leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.catalog import Catalog
from repro_torch.core.store import (FileStore, ObjectStore,
                                    get_pytree_leaves, tree_unflatten)
from repro_torch.data.tables import Table

__all__ = ["open_lake", "tables_from_snapshots", "params_from_jax",
           "params_from_store"]


def _check_snapshots(store: ObjectStore, keys: Mapping[str, str]) -> None:
    for name, key in keys.items():
        if key not in store:
            raise KeyError(f"table {name!r}: snapshot {key} is not in the "
                           f"store")
        if store.get_json(key).get("kind") != "table":
            raise ValueError(f"table {name!r}: {key} is not a table "
                             f"snapshot")


def tables_from_snapshots(store: ObjectStore,
                          keys: Mapping[str, str]) -> dict[str, Table]:
    """``{name: Table}`` for each ``{name: snapshot key}`` in ``store``."""
    _check_snapshots(store, keys)
    return {name: Table.from_blobs(store, key) for name, key in keys.items()}


def open_lake(root: str, tables: Mapping[str, str]) -> Catalog:
    """The port's catalog over the ``FileStore`` at ``root``, with
    ``tables`` (``{name: snapshot key}``, e.g. ``repro``'s
    ``catalog.tables("main")``) committed on ``main`` in one commit."""
    store = FileStore(root)
    _check_snapshots(store, tables)
    catalog = Catalog(store)
    if tables:
        catalog.write_tables("main", dict(tables), message="open lake")
    return catalog


# ---------------------------------------------------------------------------
# model parameters
# ---------------------------------------------------------------------------

def _tensor(x) -> torch.Tensor:
    """A leaf as a CPU tensor; bfloat16 (an ``ml_dtypes`` array on the
    JAX side) goes through its raw bits, so ``ml_dtypes`` is never
    imported."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _block_items(block: Mapping, prefix: str = ""):
    for name, value in block.items():
        if isinstance(value, Mapping):
            yield from _block_items(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def _layer_source(cfg: ModelConfig, i: int) -> tuple[str, int, int | None]:
    """Where ``repro`` keeps layer ``i``: ("slots", pattern slot, repeat)
    or ("tail", index, None)."""
    P, n = cfg.pattern_len, cfg.n_scan_blocks
    if i < n * P:
        return "slots", i % P, i // P
    return "tail", i - n * P, None


def params_from_jax(params: Mapping[str, Any], cfg: ModelConfig
                    ) -> dict[str, torch.Tensor]:
    """``repro``'s parameter tree for ``cfg`` as the port's
    ``Model.state_dict()`` (CPU tensors)."""
    out = {"embed": _tensor(params["embed"]),
           "final_norm.scale": _tensor(params["final_norm"]["scale"])}
    if "lm_head" in params:
        out["lm_head"] = _tensor(params["lm_head"])
    for i in range(cfg.num_layers):
        where, j, rep = _layer_source(cfg, i)
        for name, leaf in _block_items(params[where][j]):
            t = _tensor(leaf)
            out[f"layers.{i}.{name}"] = t if rep is None else t[rep]
    return out


def _jax_param_layout(cfg: ModelConfig) -> dict:
    """The structure of ``repro``'s parameter tree for ``cfg`` (leaves
    are placeholders), whose flattening order is that of its
    snapshots."""
    from repro_torch.models.model import Model
    model = Model(cfg, device="meta")
    layout: dict = {"embed": 0, "final_norm": {"scale": 0}}
    if not cfg.tie_embeddings:
        layout["lm_head"] = 0
    blocks: dict[str, list] = {"slots": [None] * cfg.pattern_len,
                               "tail": [None] * cfg.n_tail_layers}
    for i, layer in enumerate(model.layers):
        where, j, _ = _layer_source(cfg, i)
        tree: dict = {}
        for name, _p in layer.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = 0
        blocks[where][j] = tree
    layout.update(blocks)
    return layout


def params_from_store(store: ObjectStore, key: str, cfg: ModelConfig
                      ) -> dict[str, torch.Tensor]:
    """The parameter snapshot ``key`` that ``repro`` wrote (its
    ``put_pytree`` of the parameters of ``cfg``) as the port's
    ``state_dict``."""
    leaves = get_pytree_leaves(store, key)
    return params_from_jax(tree_unflatten(_jax_param_layout(cfg), leaves), cfg)
