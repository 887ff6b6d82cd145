"""Per-cell (arch × shape × mesh) program builders for the dry-run.

The port of ``repro/launch/specs.py``. Everything here works on ``meta``
tensors: no device allocation ever happens on this path (the
control-plane "moment 2" of the paper — a plan must be rejectable before
any worker spends a byte of device memory).

For each shape kind we build:
  train_4k      -> ``train_step``   (fwd + bwd + AdamW update)
  prefill_32k   -> ``prefill_step`` (fwd, last-position logits + KV out)
  decode_32k    -> ``serve_step``   (1 token against a seq_len KV cache)
  long_500k     -> ``serve_step``   (sub-quadratic archs only)

plus the matching ``meta`` arguments and their partition specs (via the
logical axis rules in :mod:`repro_torch.distributed.sharding`), from
which each argument's bytes on one rank follow exactly
(:func:`arg_bytes_per_device`). Leaves are the port's: one per layer,
where ``repro`` stacks the layers of a pattern slot, so a leaf's spec is
``repro``'s with the stacked dim dropped, and a cache's length is a host
integer (``repro``'s is an int32 scalar per layer).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import _layer_source
from repro_torch.distributed.elastic import param_spec, tree_map_named
from repro_torch.distributed.sharding import (AxisRules, PartitionSpec,
                                              axis_sizes, make_rules,
                                              safe_spec, use_rules)
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import (TrainConfig, _bind,
                                             make_train_step)

__all__ = ["CellPlan", "DryrunKnobs", "build_cell", "cell_is_skipped",
           "skip_reason", "arch_dryrun_defaults", "arg_bytes_per_device",
           "allocated_bytes",
           "abstract_params", "extra_inputs", "safe_params_sharding",
           "cache_sharding", "make_prefill_step", "make_serve_step"]

P = PartitionSpec


# ---------------------------------------------------------------------------
# skips
# ---------------------------------------------------------------------------

def cell_is_skipped(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return shape.name == "long_500k" and not cfg.sub_quadratic


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if cell_is_skipped(cfg, shape):
        return (f"{cfg.name}: pure full-attention stack — 512k-token decode "
                "needs sub-quadratic mixing (run for ssm/hybrid only)")
    return None


# ---------------------------------------------------------------------------
# per-arch dry-run defaults (``repro``'s)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DryrunKnobs:
    fsdp: bool = False
    seq_parallel: bool = True
    remat: str | None = "full"
    block_q: int = 512
    block_kv: int = 512
    loss_chunk: int = 512
    accum: int = 1
    dp_only: bool = False      # pure DP (small archs): batch on all axes
    kv_dtype: str = "float8_e4m3fn"   # decode cache storage


_BIG = {"recurrentgemma_9b", "llama4_scout_17b", "minitron_8b",
        "phi3_medium_14b", "command_r_plus_104b"}

# microbatch counts: live activations must fit next to params + opt
_ACCUM = {"command_r_plus_104b": 16, "llama4_scout_17b": 8,
          "phi3_medium_14b": 4, "minitron_8b": 4, "granite_moe_3b": 4,
          "phi4_mini_3b": 4, "phi3_vision_4b": 4, "whisper_medium": 4,
          "recurrentgemma_9b": 4}

# small archs where TP is pure overhead: replicate params, DP the batch
# across every rank (params + opt fit trivially)
_DP_ONLY = {"xlstm_350m", "whisper_medium"}


def arch_dryrun_defaults(cfg: ModelConfig) -> DryrunKnobs:
    from repro_torch.configs import _ALIASES
    # config .name carries the published id ("granite-moe-3b-a800m");
    # resolve to the registry arch id the knob tables are keyed by.
    name = _ALIASES.get(cfg.name, cfg.name.replace("-", "_"))
    return DryrunKnobs(fsdp=name in _BIG, accum=_ACCUM.get(name, 1),
                       dp_only=name in _DP_ONLY)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dt, device="meta")


def abstract_params(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in
            Model(cfg, device="meta").state_dict().items()}


def extra_inputs(cfg: ModelConfig, batch: int) -> dict[str, Any]:
    """Frontend STUB inputs (precomputed frame/patch embeddings)."""
    extra: dict[str, Any] = {}
    if cfg.encoder_layers:                       # audio (whisper)
        extra["audio_embeds"] = _meta(
            (batch, cfg.num_source_positions, cfg.d_model), cfg.dtype)
    elif cfg.family == "vlm":                    # early-fusion patches
        extra["vision_embeds"] = _meta(
            (batch, cfg.num_source_positions, cfg.d_model), cfg.dtype)
    return extra


# ---------------------------------------------------------------------------
# cache / state sharding heuristics
# ---------------------------------------------------------------------------

def _repro_cache_spec(name: str, shape: tuple, rules: AxisRules) -> P:
    """``repro``'s ``_cache_spec`` of a leaf of ``shape`` named ``name``."""
    nd = len(shape)
    if name.endswith(".k") or name.endswith(".v"):
        # (B,K,S,hd) or stacked (n,B,K,S,hd): seq over `model` (flash-
        # decode partial softmax), batch over (pod,data)
        base = ["batch", "kv_heads", "kv_seq", "head_dim"]
        pad = [None] * (nd - 4)
        return rules.resolve(*pad, *base)
    if "rec" in name and nd >= 2:
        # recurrent state: batch-major, feature dims local; repro takes a
        # leaf of 3 or more dims to lead with the stacked layer dim
        if nd >= 3:
            return rules.resolve(None, "batch", *([None] * (nd - 2)))
        return rules.resolve("batch", None)
    return rules.resolve(*([None] * nd))


def cache_sharding(caches: list, cfg: ModelConfig, mesh,
                   rules: AxisRules) -> list:
    """The spec of each cache leaf: ``repro``'s on its stacked leaf (a
    layer of a pattern slot) with the stacked dim dropped, or on the
    leaf itself (a tail layer); the host lengths have none."""
    out = []
    for i, cache in enumerate(caches):
        where, _, _ = _layer_source(cfg, i)

        def spec(name, leaf, stacked=where == "slots"):
            if not isinstance(leaf, torch.Tensor):
                return None
            shape = tuple(leaf.shape)
            if stacked:
                full = (cfg.n_scan_blocks,) + shape
                s = safe_spec(_repro_cache_spec(name, full, rules), full,
                              mesh)
                return P(*s[1:])
            return safe_spec(_repro_cache_spec(name, shape, rules), shape,
                             mesh)

        out.append(tree_map_named(spec, cache))
    return out


def safe_params_sharding(params, mesh, rules: AxisRules):
    """Each leaf's :func:`~repro_torch.distributed.elastic.param_spec` on
    ``mesh``, dims the mesh cannot divide replicated."""
    rules = dataclasses.replace(rules, mesh=mesh)
    return tree_map_named(
        lambda n, leaf: safe_spec(param_spec(n, leaf, rules),
                                  tuple(leaf.shape), mesh), params)


def _batched_spec(leaf, rules: AxisRules) -> P:
    """batch-leading activations: (B, ...)."""
    return rules.resolve("batch", *([None] * (leaf.ndim - 1)))


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, knobs: DryrunKnobs,
                      extra_spec: tuple[str, ...]) -> Callable:
    """``prefill_step(params, inputs, *extra_args) -> (last logits, kv)``.
    ``knobs.block_q``/``block_kv`` have no counterpart: the flash kernel
    picks its own tiles."""
    model = Model(cfg, device="meta")

    def prefill_step(params, inputs, *extra_args):
        extra = dict(zip(extra_spec, extra_args))
        _bind(model, params)
        out, _aux, kv = model(inputs, mode="last_logits", return_kv=True,
                              **extra)
        return out, kv
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    model = Model(cfg, device="meta")

    def serve_step(params, tokens, caches):
        _bind(model, params)
        return model.decode_step(tokens, caches)
    return serve_step


# ---------------------------------------------------------------------------
# the cell plan
# ---------------------------------------------------------------------------

def _with_rules(fn, rules):
    """Activate the logical-axis rules while the step runs: the model's
    internal ``lshard`` calls resolve against the thread-local rules, so
    they must be live inside the call, not just while specs are built."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with use_rules(rules):
            return fn(*args, **kw)
    return wrapped


@dataclasses.dataclass
class CellPlan:
    """A step, its ``meta`` arguments and each argument's spec."""
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple           # meta tensors (trees)
    in_shardings: tuple   # PartitionSpec trees, like args
    donate_argnums: tuple[int, ...]
    rules: AxisRules
    model_flops: float    # 6·N·D train / 2·N_active·tokens prefill/decode


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_act = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n_act * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.seq_len * shape.global_batch
    return 2.0 * n_act * shape.global_batch          # decode: 1 tok/seq


def _leaves(tree) -> list:
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def allocated_bytes(nbytes: int) -> int:
    """What PyTorch's CUDA caching allocator counts in
    ``torch.cuda.memory_allocated()`` for a tensor of ``nbytes`` drawn
    from fresh segments (``c10/cuda/CUDACachingAllocator.cpp``): the size
    rounded up to its 512-byte block; a request of 10 MiB or more gets a
    segment of the next 2 MiB multiple, and a remainder of 1 MiB or less
    is not split off, so the block takes the whole segment. (Requests
    between 1 and 10 MiB share 20 MiB segments; counted at their block
    size, exact when a segment's remainder is over 1 MiB.)"""
    size = max(512, -(-nbytes // 512) * 512)
    if size < 10 << 20:
        return size
    segment = -(-size // (2 << 20)) * (2 << 20)
    return segment if segment - size <= 1 << 20 else size


def arg_bytes_per_device(plan: CellPlan, mesh, *,
                         only: tuple[int, ...] | None = None,
                         allocated: bool = False) -> int:
    """The bytes one rank holds of the plan's arguments (those at the
    positions ``only``, or all): each tensor leaf's shard (its dims
    divided by the mesh axes its spec names) times its itemsize; with
    ``allocated``, what the CUDA caching allocator counts for each
    (:func:`allocated_bytes`)."""
    sizes = axis_sizes(mesh)
    total = 0
    for i, (arg, spec) in enumerate(zip(plan.args, plan.in_shardings)):
        if only is not None and i not in only:
            continue
        for leaf, s in zip(_leaves(arg), _leaves(spec)):
            if not isinstance(leaf, torch.Tensor):
                continue
            n = leaf.element_size()
            for i, d in enumerate(leaf.shape):
                e = s[i] if s is not None and i < len(s) else None
                div = 1
                for ax in (e if isinstance(e, tuple) else
                           (() if e is None else (e,))):
                    div *= sizes.get(ax, 1)
                n *= -(-d // div)
            total += allocated_bytes(n) if allocated else n
    return total


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               knobs: DryrunKnobs | None = None) -> CellPlan:
    knobs = knobs or arch_dryrun_defaults(cfg)
    kind = shape.kind
    B, S = shape.global_batch, shape.seq_len
    sizes = axis_sizes(mesh)
    n_ranks = 1
    for v in sizes.values():
        n_ranks *= v
    # pure DP only when the batch divides the whole mesh (train_4k);
    # otherwise fall back to the standard TP(+SP) rules.
    dp_only = knobs.dp_only and B % n_ranks == 0
    rules = make_rules("train" if kind == "train" else
                       ("prefill" if kind == "prefill" else "decode"),
                       mesh, fsdp=knobs.fsdp,
                       seq_parallel=knobs.seq_parallel and kind != "decode",
                       dp_only=dp_only)

    # long_500k runs a single sequence: batch cannot shard over the DP
    # axes — replicate batch, parallelism comes from TP + kv_seq shards.
    dp = 1
    entry = rules.rules.get("batch")
    for ax in (entry if isinstance(entry, tuple) else (entry,)):
        dp *= sizes.get(ax, 1)
    if B % dp != 0:
        rules = AxisRules(dict(rules.rules, batch=None), mesh)

    with use_rules(rules):
        params = abstract_params(cfg)
        p_shard = safe_params_sharding(params, mesh, rules)
        extra = extra_inputs(cfg, B)
        extra_names = tuple(extra)
        extra_avals = tuple(extra.values())
        extra_shard = tuple(_batched_spec(a, rules) for a in extra_avals)
        tok_shard = rules.resolve("batch", None)

        if kind == "train":
            tc = TrainConfig(remat=knobs.remat, block_q=knobs.block_q,
                             block_kv=knobs.block_kv, accum=knobs.accum,
                             device="meta")
            fn = make_train_step(cfg, AdamWConfig(), tc,
                                 extra_spec=dict.fromkeys(extra_names)
                                 if extra_names else None,
                                 model=Model(cfg, device="meta"))
            opt = adamw_init(params)
            o_shard = safe_params_sharding(opt, mesh, rules)
            args = (params, opt, _meta((B, S), "int32"),
                    _meta((B, S), "int32"), *extra_avals)
            in_sh = (p_shard, o_shard, tok_shard, tok_shard, *extra_shard)
            return CellPlan(cfg.name, shape.name, kind,
                            _with_rules(fn, rules), args, in_sh,
                            donate_argnums=(0, 1), rules=rules,
                            model_flops=_model_flops(cfg, shape))

        if kind == "prefill":
            fn = make_prefill_step(cfg, knobs, extra_names)
            args = (params, _meta((B, S), "int32"), *extra_avals)
            in_sh = (p_shard, tok_shard, *extra_shard)
            return CellPlan(cfg.name, shape.name, kind,
                            _with_rules(fn, rules), args, in_sh,
                            donate_argnums=(), rules=rules,
                            model_flops=_model_flops(cfg, shape))

        # decode: 1 new token against a seq_len cache (fp8 storage)
        cfg = dataclasses.replace(cfg, kv_dtype=knobs.kv_dtype)
        enc = (_meta((B, cfg.num_source_positions, cfg.d_model), cfg.dtype)
               if cfg.encoder_layers else None)
        caches = Model(cfg, device="meta").init_cache(B, S, enc_out=enc)
        c_shard = cache_sharding(caches, cfg, mesh, rules)
        fn = make_serve_step(cfg)
        args = (params, _meta((B, 1), "int32"), caches)
        in_sh = (p_shard, tok_shard, c_shard)
        return CellPlan(cfg.name, shape.name, kind,
                        _with_rules(fn, rules), args, in_sh,
                        donate_argnums=(2,), rules=rules,
                        model_flops=_model_flops(cfg, shape))
