"""Logical-axis sharding rules (MaxText-style) for all architectures.

The port of ``repro/distributed/sharding.py``. Model code never names
physical mesh axes. It tags tensors with *logical* axis names
(``"batch"``, ``"heads"``, ``"ff"`` …) via :func:`lshard`; an
:class:`AxisRules` mapping, per arch × shape and chosen by the launcher,
resolves logical names to physical mesh axes. The same model definition
then runs on one card (no rules: every call is a no-op), on a
``(data, model)`` mesh or on a ``(pod, data, model)`` mesh.

Physical axes:
  pod    — slow inter-pod links: pure DP (+ compressed grad all-reduce)
  data   — intra-pod DP / FSDP axis; batch dim; decode: also KV-seq shards
  model  — TP axis: heads / ff / vocab / experts; decode: KV-seq shards

A mesh is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (one program per rank, over
a process group) or a :class:`MeshShape` (names and sizes only: what the
dry-run reads). A resolved spec maps onto DTensor placements
(:func:`placements`): a tensor dim that names a mesh axis is ``Shard`` on
that mesh dim, every other mesh dim ``Replicate``. :func:`lshard` is
GSPMD's ``with_sharding_constraint``: a ``redistribute`` of a DTensor.

``repro``'s ``shard_map`` wrapper has no counterpart: a torch program is
already one program per rank, and the collectives it would hide are
called by name (``grad_compression.py``, ``pipeline_parallel.py``).

Non-divisible dims (e.g. 40 heads over a 16-way model axis): an argument
spec drops them (:func:`safe_spec`), as ``repro``'s jit arguments must.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Mapping

import torch

__all__ = ["AxisRules", "MeshShape", "PartitionSpec", "use_rules", "lshard",
           "logical_spec", "local_call", "named_sharding", "placements",
           "safe_spec", "split_last", "merge_last", "embedding",
           "write_slot",
           "gather_inner", "gather_inner_grad",
           "axis_sizes", "TRAIN_RULES", "DECODE_RULES", "FSDP_RULES",
           "SP_SUFFIX", "DP_ONLY_RULES", "current_rules", "make_rules"]

AxisEntry = str | tuple[str, ...] | None


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis, a tuple of them, or None.

    A tuple, normalized as ``jax.sharding.PartitionSpec`` normalizes its
    entries (a one-axis tuple is the axis, an empty one None), so a spec
    of either package compares equal to the other as a tuple.
    """

    def __new__(cls, *entries: AxisEntry):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices or processes
    behind it (the dry-run's production meshes)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a :class:`MeshShape`'s or a
    ``DeviceMesh``'s ``mesh_dim_names``."""
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, for a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> physical mesh axis (or axes, or None)."""

    rules: Mapping[str, AxisEntry]
    mesh: object | None = None

    def resolve(self, *names: str | None) -> PartitionSpec:
        out = []
        used: set[str] = set()
        for n in names:
            if n is None:
                out.append(None)
                continue
            entry = self.rules.get(n)
            # drop axes the mesh doesn't have (single-pod vs multi-pod)
            if entry is not None and self.mesh is not None:
                have = set(axis_names(self.mesh))
                if isinstance(entry, tuple):
                    entry = tuple(a for a in entry if a in have) or None
                elif entry not in have:
                    entry = None
            # a mesh axis may appear at most once per spec: first logical
            # name wins (e.g. under sequence parallelism `heads` takes
            # `model`; `seq` then resolves to None inside attention)
            if entry is not None:
                if isinstance(entry, tuple):
                    entry = tuple(a for a in entry if a not in used) or None
                    if entry:
                        used.update(entry)
                elif entry in used:
                    entry = None
                else:
                    used.add(entry)
            out.append(entry)
        return P(*out)


_local = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules | None):
    """Make ``rules`` the thread's active rules. With a ``DeviceMesh``
    behind them, plain tensors that meet a DTensor inside the block (the
    model's positions, masks, RoPE tables) count as replicated on it."""
    prev = current_rules()
    _local.rules = rules
    try:
        if rules is not None and _is_device_mesh(rules.mesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield rules
        else:
            yield rules
    finally:
        _local.rules = prev


def _is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, MeshShape)


def logical_spec(*names: str | None) -> PartitionSpec:
    r = current_rules()
    if r is None:
        return P(*([None] * len(names)))
    return r.resolve(*names)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dim that an
    entry names is ``Shard`` of that entry's tensor dim, in the entry's
    order; every other mesh dim is ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(ax)] = Shard(dim)
    return tuple(out)


def _is_dtensor(x) -> bool:
    # no tensor is a DTensor before its module is loaded, and loading it
    # takes seconds: a process that shards nothing never does
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _under_rules(x) -> bool:
    return current_rules() is not None and _is_dtensor(x)


def lshard(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Apply a logical sharding constraint: ``x`` redistributed to the
    placements ``names`` resolve to on its mesh. A no-op outside rules,
    and on a tensor that is not a DTensor. A dim the mesh cannot divide
    evenly stays replicated (:func:`safe_spec`), where GSPMD would pad
    it: an uneven shard cannot be viewed into heads and back."""
    r = current_rules()
    if r is None or r.mesh is None or not _is_dtensor(x):
        return x
    spec = safe_spec(r.resolve(*names), tuple(x.shape), x.device_mesh)
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def local_call(fn, *tensors: torch.Tensor, lead: int, **kwargs):
    """``fn(*tensors, **kwargs)`` on each rank's own rows.

    ``fn`` (a kernel's wrapper) computes each index of the ``lead``
    leading dims of its inputs independently (batch and heads), and its
    output has those leading dims too. Outside rules, and on plain
    tensors, this is the call itself. On DTensors it is ``local_map``:
    every input takes the first input's shards on its leading dims (a
    ``Replicate`` input is sliced, which moves nothing), and ``fn`` runs
    on the local tensors. A mesh dim that shards a later dim, or a
    leading dim that some input cannot split evenly (GQA's K below the
    model axis), is gathered first: that is compute the mesh dim
    replicates.
    """
    if not any(_under_rules(t) for t in tensors):
        return fn(*tensors, **kwargs)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    first = next(t for t in tensors if _is_dtensor(t))
    mesh = first.device_mesh
    want = []
    for mdim, p in enumerate(first.placements):
        ok = (isinstance(p, Shard) and p.dim < lead
              and all(t.shape[p.dim] % mesh.size(mdim) == 0
                      for t in tensors))
        want.append(p if ok else Replicate())
    want = tuple(want)
    ins = [t.redistribute(mesh, want) if _is_dtensor(t)
           else _replicated(t, mesh).redistribute(mesh, want)
           for t in tensors]
    # a tuple of placements reads as one per output: one output, a list
    return local_map(lambda *local: fn(*local, **kwargs),
                     out_placements=list(want),
                     in_placements=tuple(list(want) for _ in ins),
                     device_mesh=mesh)(*ins)


def embedding(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: rows of an embedding table. A DTensor table
    sharded over its rows (the vocabulary) takes the vocab-parallel
    lookup: each rank looks up the tokens its rows hold, zeros the rest,
    and the output is a partial sum over that mesh dim, which the next
    ``lshard`` reduces (an all-reduce of the activations, never a gather
    of the table)."""
    import torch.nn.functional as F
    if not _under_rules(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if not any(isinstance(p, Shard) and p.dim == 0
               for p in table.placements):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    # a table split over d_model too (FSDP) is gathered on that dim first
    table = _whole(table, (1,))
    tok_pl = (list(tokens.placements) if _is_dtensor(tokens)
              else [Replicate()] * mesh.ndim)
    vocab_dims = [md for md, p in enumerate(table.placements)
                  if isinstance(p, Shard) and p.dim == 0]
    out_pl = [Partial() if md in vocab_dims else tok_pl[md]
              for md in range(mesh.ndim)]
    V = table.shape[0]

    def lookup(tok, rows):
        # this rank's first row: torch.chunk's split of V over the dims
        lo, span = 0, V
        for md in vocab_dims:
            n = mesh.size(md)
            step = -(-span // n)
            lo += mesh.get_local_rank(md) * step
            span = step
        idx = tok.long() - lo
        hit = (idx >= 0) & (idx < rows.shape[0])
        out = F.embedding(idx.clamp(0, rows.shape[0] - 1), rows)
        return out * hit[..., None].to(out.dtype)

    # each rank's table gradient holds only its own tokens' rows: a
    # partial sum over the mesh dims that split the tokens
    grad_pl = [Partial() if isinstance(tp, Shard) and not isinstance(
        p, Shard) else p for tp, p in zip(tok_pl, table.placements)]
    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tok_pl if _is_dtensor(tokens) else None,
                                    list(table.placements)),
                     in_grad_placements=(tok_pl, grad_pl),
                     device_mesh=mesh)(tokens, table)


def write_slot(cache: torch.Tensor, dim: int, index: int,
               value: torch.Tensor) -> None:
    """``cache.select(dim, index).copy_(value)``, in place: a decode
    step's new K/V into its ring slot. On a DTensor ``cache`` split over
    ``dim`` (the KV sequence under decode rules), the rank that holds the
    slot writes it into its own shard and the others write nothing;
    ``value`` takes the cache's placements on its other dims."""
    if not _under_rules(cache):
        cache.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    lo, span = 0, cache.shape[dim]
    want = []
    for md, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == dim:
            # torch.chunk's split, over the mesh dims in order
            step = -(-span // mesh.size(md))
            lo += mesh.get_local_rank(md) * step
            span = step
            want.append(Replicate())
        elif isinstance(p, Shard):
            want.append(Shard(p.dim - (p.dim > dim)))
        else:
            want.append(p)
    if not _is_dtensor(value):
        value = _replicated(value, mesh)
    value = value.redistribute(mesh, want).to_local()
    local = cache.to_local()
    if lo <= index < lo + local.shape[dim]:
        local.select(dim, index - lo).copy_(value)


def _whole(x, dims):
    """``x`` (a DTensor) with its shards of tensor dims ``dims`` made
    whole."""
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _WholeGrad(torch.autograd.Function):
    """Identity; its gradient made whole on the tensor dims ``dims``."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.dims), None


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every shard of a dim between its first and its last
    made whole (a no-op outside rules, and on a plain tensor)."""
    if not _under_rules(x) or x.ndim < 3:
        return x
    return _whole(x, range(1, x.ndim - 1))


def gather_inner_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient is made whole on its inner dims before it
    flows back (:func:`gather_inner` for the backward pass)."""
    if not _under_rules(y) or y.ndim < 3:
        return y
    return _WholeGrad.apply(y, range(1, y.ndim - 1))


def split_last(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """``x`` (..., n·m) as (..., n, m): heads out of a projection. A
    DTensor whose last dim is sharded over a mesh dim that does not
    divide ``n`` (24 heads on a 16-way axis) is gathered on that dim
    first: the heads cannot split evenly, so that mesh dim replicates
    the attention's compute (GSPMD pads instead)."""
    if _under_rules(x):
        from torch.distributed.tensor import Replicate, Shard
        want = [Replicate() if isinstance(p, Shard) and p.dim == x.ndim - 1
                and n % x.device_mesh.size(md) else p
                for md, p in enumerate(x.placements)]
        if want != list(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(*x.shape[:-1], n, m)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n, m) as (..., n·m): heads into an output projection.
    When a mesh dim cannot split n evenly (``split_last`` gathered the
    heads), the gradient coming back is gathered on its last dim before
    it is unflattened into heads."""
    n, m = x.shape[-2], x.shape[-1]
    y = x.reshape(*x.shape[:-2], n * m)
    if _under_rules(y) and any(n % x.device_mesh.size(md)
                               for md in range(x.device_mesh.ndim)):
        y = _WholeGrad.apply(y, (y.ndim - 1,))
    return y


def _replicated(t: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def safe_spec(spec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Drop sharding on dims the mesh cannot divide evenly.

    An argument's placement must divide evenly, as ``repro``'s jit
    argument shardings must; replication of the offending dim is always
    correct — e.g. whisper's 1500 encoder frames on a 16-way axis.
    """
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for ax in axes:
            n *= sizes.get(ax, 1)
        out.append(entry if shape[i] % n == 0 else None)
    return P(*out)


def named_sharding(mesh, *names: str | None,
                   rules: AxisRules | None = None):
    """``(mesh, placements)`` of the logical ``names`` under ``rules``
    (or the active rules) on ``mesh``: ``repro``'s ``NamedSharding``."""
    r = rules or current_rules() or AxisRules({}, mesh)
    r = dataclasses.replace(r, mesh=mesh)
    return mesh, placements(r.resolve(*names), mesh)


# ---------------------------------------------------------------------------
# Standard rule sets
# ---------------------------------------------------------------------------

# Megatron-style TP + DP for training / prefill. Activations keep d_model
# unsharded; heads/ff/vocab split over `model`; batch over (pod, data).
TRAIN_RULES: dict[str, AxisEntry] = {
    "batch": ("pod", "data"),
    "seq": None,              # sequence stays local in training
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "kv_seq": None,
    # parameter axes
    "p_embed_vocab": "model",
    "p_heads": "model",
    "p_kv_heads": "model",
    "p_ff": "model",
    "p_embed": None,          # FSDP_RULES overrides to ("data",)
    "p_experts": "model",
    "p_moe_inner": None,      # FSDP_RULES overrides to ("data",)
    "layers": None,
}

# FSDP: parameters additionally sharded over `data` on their d_model axis
# (all-gathered on use).
FSDP_RULES: dict[str, AxisEntry] = dict(
    TRAIN_RULES,
    p_embed=("data",),
    p_moe_inner=("data",),
)

# Megatron-style sequence parallelism: the residual stream between blocks
# is sharded over `model` along seq (the norm/elementwise regions), and
# the TP all-reduces become all-gather + reduce-scatter pairs around
# attention/FFN.
SP_SUFFIX: dict[str, AxisEntry] = {"seq": "model"}

# Decode: KV cache sequence-sharded over `model` (flash-decode partial
# softmax: works for ANY head count — no divisibility constraint), batch
# over (pod, data). Weights stay TP-sharded.
DECODE_RULES: dict[str, AxisEntry] = dict(
    TRAIN_RULES,
    batch=("pod", "data"),
    kv_seq="model",
    heads=None,            # activations: 1-token q, replicate heads
    kv_heads=None,
)


# Pure data parallelism: batch spans EVERY mesh axis; parameters are
# replicated. The right strategy for small models (xlstm-350m: d=1024),
# where TP would make every activation collective cost more than the
# compute. The gradient all-reduce is the only collective left.
DP_ONLY_RULES: dict[str, AxisEntry] = {
    **{k: None for k in TRAIN_RULES},
    "batch": ("pod", "data", "model"),
}


def make_rules(kind: str, mesh, *, fsdp: bool = False,
               seq_parallel: bool = False,
               dp_only: bool = False) -> AxisRules:
    # NOTE: prefill returns the KV cache in the decode layout — its seq
    # axis shards over `model` (resolve() dedups against SP's use).
    if dp_only and kind in ("train", "prefill"):
        base = dict(DP_ONLY_RULES)
        if fsdp:
            # ZeRO-style: params/opt sharded over `data`, gathered on use
            base["p_embed"] = ("data",)
            base["p_moe_inner"] = ("data",)
        return AxisRules(base, mesh)
    if kind in ("train", "prefill"):
        base = dict(FSDP_RULES if fsdp else TRAIN_RULES)
        if seq_parallel:
            base.update(SP_SUFFIX)
        if kind == "prefill":
            base["kv_seq"] = "model"
    elif kind == "decode":
        base = dict(DECODE_RULES)
        if fsdp:
            base["p_embed"] = ("data",)
            base["p_moe_inner"] = ("data",)
    else:
        raise ValueError(kind)
    return AxisRules(base, mesh)
