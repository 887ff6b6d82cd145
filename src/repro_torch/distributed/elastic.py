"""Elastic rescaling: restore any checkpoint onto any mesh shape.

The port of ``repro/distributed/elastic.py``. Checkpoints are stored as
*logical* (unsharded, host-side) snapshots in the versioned store, so
rescaling is purely a placement change: :func:`reshard` distributes
every leaf with the placements derived from the new mesh and axis rules.
Growing or shrinking the data axis changes only the per-rank batch; a
TP degree change re-slices parameter matrices. No tensor surgery.

The global batch contract is preserved across rescales (the pipeline
cursor is part of the checkpoint), so a run can continue on fewer ranks
after losing some: slow but *correct*, the paper's partial-vs-total
failure upgrade applied to cluster capacity.

Leaves are named by the port's dotted ``state_dict`` names
(``layers.0.mix.wq``, ``layers.0.ffn.experts.w_down``, ``mu.embed`` in an
optimizer state). ``repro`` stacks the layers of each pattern slot on a
leading dim; the port keeps one leaf per layer, so its spec is
``repro``'s with that leading dim dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import (AxisRules, PartitionSpec,
                                              axis_sizes, placements,
                                              safe_spec)

__all__ = ["param_spec", "params_sharding", "reshard", "tree_map_named"]

P = PartitionSpec

_COLUMN = ("wq", "wk", "wv", "w_gate", "w_up", "proj_gate", "proj_rec",
           "w_in", "w_a", "w_x")
_ROW = ("wo", "w_down", "proj_out", "w_out")


def param_spec(name: str, leaf, rules: AxisRules) -> PartitionSpec:
    """Heuristic logical spec for a parameter leaf by name/rank."""
    nd = leaf.ndim
    if "embed" in name and nd == 2:          # (V, d)
        return rules.resolve("p_embed_vocab", "p_embed")
    if "lm_head" in name and nd == 2:        # (d, V)
        return rules.resolve("p_embed", "p_embed_vocab")
    if "experts" in name and nd >= 3:        # (E, d, f)
        # expert dim over `model` (EP) when divisible; otherwise fall
        # back to TP *within* experts (granite's 40 experts on a 16-way
        # model axis): shard the f dim — column-parallel for up/gate
        # (…, d, f), row-parallel for w_down (…, f, d).
        ep_ok = True
        ent = rules.rules.get("p_experts")
        if rules.mesh is not None and ent is not None:
            sizes = axis_sizes(rules.mesh)
            for ax in (ent if isinstance(ent, tuple) else (ent,)):
                if ax in sizes:
                    ep_ok &= leaf.shape[nd - 3] % sizes[ax] == 0
        pad = [None] * (nd - 3)
        if ep_ok:
            return rules.resolve(*pad, "p_experts", "p_moe_inner", None)
        if "w_down" in name:
            return rules.resolve(*pad, None, "p_ff", "p_moe_inner")
        return rules.resolve(*pad, None, "p_moe_inner", "p_ff")
    if nd >= 2 and any(s in name for s in _COLUMN):
        pad = [None] * (nd - 2)
        return rules.resolve(*pad, "p_embed", "p_ff")   # column-parallel
    if nd >= 2 and any(s in name for s in _ROW):
        pad = [None] * (nd - 2)
        return rules.resolve(*pad, "p_ff", "p_embed")   # row-parallel
    if "conv_w" in name and nd >= 2:         # (k, w): width over model
        pad = [None] * (nd - 2)
        return rules.resolve(*pad, None, "p_ff")
    if "lam" in name and nd >= 1:            # (w,)
        pad = [None] * (nd - 1)
        return rules.resolve(*pad, "p_ff")
    return P(*([None] * nd))


def tree_map_named(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """``fn(name, leaf)`` over a tree of dicts and NamedTuples (an
    optimizer state) whose leaves are tensors; a leaf's name joins the
    keys and field names on its path with dots."""
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, v, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_named(fn, getattr(tree, f),
                                           f"{prefix}{f}.")
                            for f in tree._fields))
    if tree is None:
        return None
    return fn(prefix[:-1], tree)


def params_sharding(params: Any, mesh, rules: AxisRules) -> Any:
    """The tree of each leaf's :func:`param_spec` on ``mesh``."""
    rules = dataclasses.replace(rules, mesh=mesh)
    return tree_map_named(lambda n, leaf: param_spec(n, leaf, rules), params)


def reshard(tree: Any, mesh, rules: AxisRules) -> Any:
    """Place a tree (a host-side checkpoint, or tensors on the card) onto
    the ``DeviceMesh`` ``mesh``: each leaf a DTensor with its
    :func:`param_spec`, dims the mesh cannot divide replicated
    (:func:`~repro_torch.distributed.sharding.safe_spec`). Every rank
    passes the same full values and keeps its own shard, cut where the
    leaf lies and then moved to the mesh's device in storage of its own
    (no view keeps the whole leaf alive, and a host leaf never lands
    whole on the card); nothing crosses between ranks."""
    from torch.distributed.tensor import DTensor, Shard
    rules = dataclasses.replace(rules, mesh=mesh)
    device = torch.device(mesh.device_type)
    coord = mesh.get_coordinate()

    def place(name, leaf):
        leaf = leaf.detach()
        spec = safe_spec(param_spec(name, leaf, rules), tuple(leaf.shape),
                         mesh)
        pl = placements(spec, mesh)
        local = leaf
        for md, p in enumerate(pl):     # torch.chunk's split, mesh order
            if isinstance(p, Shard):
                local = local.chunk(mesh.size(md), dim=p.dim)[coord[md]]
        if local.device != device or local.untyped_storage().nbytes() \
                > local.numel() * local.element_size():
            local = local.to(device, copy=True).contiguous()
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return tree_map_named(place, tree)
