"""AdamW state, as much of ``repro/training/optimizer.py`` as serving
needs: the launcher publishes a fresh optimizer state beside the
parameters in every checkpoint. The update rule, schedules and clipping
come with the training slice (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.store import tree_flatten, tree_unflatten

__all__ = ["AdamWState", "adamw_init"]


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Any                  # tree like params
    nu: Any                  # tree like params


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
