"""AdamW + LR schedules + global-norm clipping, implemented in-repo.

The port of ``repro/training/optimizer.py``. Optimizer states are plain
trees (the parameters' ``name -> tensor`` dict, or any tree that
:func:`~repro_torch.core.store.tree_flatten` walks), updates are pure
functions that return new tensors, and a state is checkpointed through
the versioned store like the parameters.

The arithmetic is ``repro``'s, in float32 tensors on the parameters'
device: the schedule, the clipping scale and the bias corrections
(``b1 ** step`` with the step as a float32 tensor) are float32 tensors,
not Python floats, and each update runs in float32 and is cast back to
its parameter's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.store import tree_flatten, tree_unflatten

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "lr_at",
           "global_norm", "clip_by_global_norm", "adamw_update"]


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # tree like params
    nu: Any                  # tree like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"       # "cosine" | "linear" | "constant"


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32."""
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(_f32(math.pi, dev) * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = torch.ones_like(t)
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def adamw_init(params: Any) -> AdamWState:
    """Zero moments (float32, on each parameter's device) and step 0."""
    leaves, _ = tree_flatten(params)

    def zeros():
        return tree_unflatten(params, [
            torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for x in leaves])

    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(), nu=zeros())


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32."""
    leaves = [x.float().square().sum() for x in tree_flatten(tree)[0]]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Every leaf, in float32, scaled by ``min(1, max_norm / norm)``;
    and the norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    leaves, _ = tree_flatten(grads)
    return tree_unflatten(grads, [g.float() * scale for g in leaves]), norm


def adamw_update(cfg: AdamWConfig, grads: Any, state: AdamWState,
                 params: Any) -> tuple[Any, AdamWState, dict]:
    """Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(_f32(b1, step.device), stepf)
    c2 = 1 - torch.pow(_f32(b2, step.device), stepf)

    def upd(g, m, v, p):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mh = m / c1
        vh = v / c2
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m, v

    flat_p, _ = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state.mu)
    flat_v, _ = tree_flatten(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("grads and moments must have the parameters' "
                         "structure")
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        p2, m2, v2 = upd(g, m, v, p)
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    new_state = AdamWState(step=step, mu=tree_unflatten(state.mu, new_m),
                           nu=tree_unflatten(state.nu, new_v))
    return (tree_unflatten(params, new_p), new_state,
            {"grad_norm": gnorm, "lr": lr})
