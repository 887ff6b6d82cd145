"""Training loop: contracts at every boundary, transactional publication.

The port of ``repro/training/train_loop.py``. The loop is itself a
pipeline in the paper's sense:

    data batch --(TensorContract)--> train_step --(finite check)-->
    checkpoint tables --(TransactionalRun)--> branch commit

- the batch contract is validated on the device before the step (worker
  moment);
- ``train_step`` is a pure function of ``(params, opt_state, inputs,
  targets)``: loss (z-loss + CE) + AdamW, returning new tensors;
- every ``ckpt_every`` steps the manager atomically publishes
  {params, opt_state, data_state, metrics} (paper §3.3);
- on restart, :func:`train` resumes from the branch head, and the
  committed pipeline cursor replays the same token stream.

Parameters are the port's ``state_dict`` names mapped to tensors (the
tree ``convert.params_from_jax`` makes from ``repro``'s). A step binds
them into a :class:`~repro_torch.models.model.Model` as its parameters,
without a copy, and takes ``torch.autograd.grad`` of the loss with
respect to them. Where ``repro`` jits the step, the port runs it eagerly:
the model kernels' wrappers carry their own backward
(``kernels/autograd.py``). ``repro``'s flash tile sizes (``block_q``,
``block_kv``) and its unused ``log_every`` have no counterpart: the
port's flash kernel picks its own tiles. A MoE model's load-balancing
loss enters the loss at ``aux_weight``; the audio and vision families
take their stub embeddings as ``extra`` (``loss_fn``) or as the train
step's trailing arguments named by ``extra_spec``, as in ``repro``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils import checkpoint

from repro_torch.checkpoints.checkpointing import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.schema import TensorContract
from repro_torch.core.store import tree_flatten, tree_unflatten
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)

__all__ = ["TrainConfig", "batch_contract", "loss_fn", "make_grad_fn",
           "make_train_step", "train"]

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    # accepted for repro's callers and ignored: repro's train never reads
    # it either
    log_every: int = 10
    remat: str | None = None
    z_loss: float = 1e-4
    aux_weight: float = 1e-2
    # accepted for repro's callers and ignored: the flash kernel picks its
    # own tiles (kernels/flash_attention/kernel.py)
    block_q: int = 512
    block_kv: int = 512
    seed: int = 0
    # microbatch gradient accumulation: the global batch is split into
    # `accum` microbatches run one after another; live activation memory
    # shrinks ~accum× while grads accumulate in float32.
    accum: int = 1
    # where the model lives and steps: the card unless the caller says
    # otherwise
    device: str = "cuda"


def batch_contract(cfg: ModelConfig, batch: int, seq: int
                   ) -> dict[str, TensorContract]:
    return {
        "inputs": TensorContract((batch, seq), "int32"),
        "targets": TensorContract((batch, seq), "int32"),
    }


class _Bf16GradBarrier(torch.autograd.Function):
    """Identity whose cotangent is rounded to bfloat16.

    ``repro`` computes the chunked CE in float32, so the cotangent
    flowing back into the model is float32; activations are bfloat16 and
    their gradients can be too. For a float32 ``hidden`` JAX hands the
    bfloat16 cotangent on and the float32 operations below promote it
    back: the cotangent is rounded to bfloat16 once. Autograd casts a
    gradient to its input's dtype, which does the same here.
    """

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def _chunk_ce(h, t, head, vocab_size: int):
    """Summed CE and summed logz² of one chunk, in float32."""
    logits = h.float() @ head.float()
    if head.shape[1] != vocab_size:          # mask vocab-padding columns
        pad = torch.arange(head.shape[1], device=h.device) >= vocab_size
        logits = torch.where(pad, -1e30, logits)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, t.long()[..., None])[..., 0]
    return (logz - tgt).sum(), logz.square().sum()


def _bind(model: Model, params: Params) -> None:
    """Make ``params`` the model's parameters, as they are (no copy, no
    ``nn.Parameter`` wrapper), so gradients reach these tensors."""
    names = {n for n, _ in model.named_parameters()}
    if names != set(params):
        raise KeyError(f"params do not fit {model.cfg.name}: missing "
                       f"{sorted(names - set(params))[:5]}, unexpected "
                       f"{sorted(set(params) - names)[:5]}")
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = t


def loss_fn(params: Params, cfg: ModelConfig, inputs, targets, *,
            z_loss: float, aux_weight: float, remat=None, extra=None,
            loss_chunk: int = 512, model: Model | None = None):
    """Chunked cross-entropy: the (B, S, V) logits are never whole — the
    LM head and CE run per ``loss_chunk`` slice of the sequence, each
    recomputed in the backward pass. ``extra`` holds the model's other
    inputs (``audio_embeds``, ``vision_embeds``). ``model`` is the module
    ``params`` are bound into (a shell on ``meta`` by default)."""
    model = model if model is not None else Model(cfg, device="meta")
    _bind(model, params)
    hidden, aux = model(inputs, mode="hidden", remat=remat, **(extra or {}))
    hidden = _Bf16GradBarrier.apply(hidden)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    B, S, _ = hidden.shape
    chunk = min(loss_chunk, S)
    if S % chunk:
        raise ValueError(f"the loss chunk ({chunk}) must divide S ({S})")
    ce_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S, chunk):
        ce_c, z_c = checkpoint.checkpoint(
            _chunk_ce, hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk],
            head, cfg.vocab_size, use_reentrant=False)
        ce_sum = ce_sum + ce_c
        z_sum = z_sum + z_c
    n = B * S
    ce = ce_sum / n
    zl = z_loss * z_sum / n
    total = ce + zl + aux_weight * aux
    return total, {"ce": ce, "z": zl, "aux": aux}


def make_grad_fn(cfg: ModelConfig, tc: TrainConfig, *,
                 model: Model | None = None) -> Callable:
    """``grad_fn(params, inputs, targets, extra=None) -> ((loss, parts),
    grads)``:
    ``jax.value_and_grad(loss_fn, has_aux=True)`` of ``repro``'s step;
    ``grads`` has the params' names and dtypes."""
    model = model if model is not None else Model(cfg, device="meta")

    def grad_fn(params: Params, inputs, targets, extra=None):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, parts = loss_fn(leaves, cfg, inputs, targets,
                              z_loss=tc.z_loss, aux_weight=tc.aux_weight,
                              remat=tc.remat, extra=extra, model=model)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
                dict(zip(leaves, grads)))

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    tc: TrainConfig, extra_spec: dict | None = None, *,
                    model: Model | None = None) -> Callable:
    """``train_step(params, opt_state, inputs, targets, *extra_args) ->
    (new_params, new_opt_state, metrics)``, ``repro``'s step: the extra
    arguments are the model's other inputs, named in order by
    ``extra_spec``'s keys; with ``tc.accum`` = M > 1 the batch (and each
    extra input) is split into M microbatches along its first axis, whose
    gradients accumulate in float32 and are divided by M."""
    grad_fn = make_grad_fn(cfg, tc, model=model)

    def train_step(params: Params, opt_state: AdamWState, inputs, targets,
                   *extra_args):
        extra = dict(zip(extra_spec, extra_args)) if extra_spec else None
        M = tc.accum
        if M <= 1:
            (loss, parts), grads = grad_fn(params, inputs, targets, extra)
        else:
            B = inputs.shape[0]
            if B % M:
                raise ValueError(f"batch {B} does not split into {M} "
                                 f"microbatches")
            m = B // M
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            zero = torch.zeros((), dtype=torch.float32, device=inputs.device)
            loss, parts = zero, {"ce": zero, "z": zero, "aux": zero}
            for i in range(M):
                rows = slice(i * m, (i + 1) * m)
                (l_i, p_i), g = grad_fn(
                    params, inputs[rows], targets[rows],
                    {k: v[rows] for k, v in extra.items()} if extra
                    else None)
                grads = {k: grads[k] + g[k].float() for k in grads}
                loss = loss + l_i
                parts = {k: parts[k] + p_i[k] for k in parts}
            grads = {k: g / M for k, g in grads.items()}
            loss = loss / M
            parts = {k: x / M for k, x in parts.items()}
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(opt_cfg, grads,
                                                   opt_state, params)
        return new_params, new_opt, {"loss": loss, **parts, **om}

    return train_step


def _like(tree: Any, like: Any) -> Any:
    """``tree``'s leaves (a checkpoint's CPU tensors) on the device and in
    the dtype of ``like``'s."""
    leaves, _ = tree_flatten(tree)
    ref, _ = tree_flatten(like)
    return tree_unflatten(like, [x.to(device=r.device, dtype=r.dtype)
                                 for x, r in zip(leaves, ref)])


def train(cfg: ModelConfig, *, pipeline: DataPipeline,
          opt_cfg: AdamWConfig, tc: TrainConfig,
          ckpt: CheckpointManager | None = None,
          params: Params | None = None, opt_state=None,
          jit_fn: Callable | None = None,
          on_step: Callable[[int, dict], None] | None = None) -> dict:
    """Run the loop on ``tc.device``; resumes from ``ckpt``'s branch head
    when present. The weights are drawn on the device from a
    ``torch.Generator`` seeded with ``tc.seed`` unless ``params`` are
    given. ``jit_fn`` is a prebuilt train step (``repro``'s jitted one;
    here any function of :func:`make_train_step`'s signature)."""
    device = torch.device(tc.device)
    model = Model(cfg, device=device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(tc.seed)
        model.init_params(gen)
        params = {k: v.detach() for k, v in model.state_dict().items()}
    if opt_state is None:
        opt_state = adamw_init(params)

    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore(params, opt_state)
        if restored is not None:
            p, o, data_state, _ = restored
            params, opt_state = _like(p, params), _like(o, opt_state)
            start_step = int(data_state["step"])
            pipeline.state = type(pipeline.state).from_json(
                {k: data_state[k] for k in
                 ("shard_order_seed", "epoch", "step")})

    step_fn = jit_fn or make_train_step(cfg, opt_cfg, tc, model=model)
    contracts = batch_contract(cfg, pipeline.batch, pipeline.seq_len)

    history = []
    for step in range(start_step, tc.steps):
        inputs, targets = (torch.from_numpy(x).to(device)
                           for x in pipeline.next_batch())
        # worker-moment contract check on the physical batch
        contracts["inputs"].validate_concrete(inputs, "inputs")
        contracts["targets"].validate_concrete(targets, "targets")
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, inputs,
                                             targets)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - t0
        history.append({"step": step, **metrics})
        if on_step:
            on_step(step, metrics)
        if ckpt is not None and (step + 1) % tc.ckpt_every == 0:
            ckpt.save(step=step + 1, params=params, opt_state=opt_state,
                      data_state=pipeline.state.to_json(),
                      metrics=metrics, code=f"{cfg.name}@{step + 1}")
    return {"params": params, "opt_state": opt_state, "history": history}
