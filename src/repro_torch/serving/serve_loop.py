"""Batched serving against a *pinned commit* of the model catalog.

The port of ``repro/serving/serve_loop.py``, step for step. Serving
reads params from an immutable commit/tag — never a moving branch — so a
training run publishing a new checkpoint can never tear a serving
replica (the paper's snapshot-read guarantee at the serving boundary).
Promotion is a catalog operation (tag / merge), not a file copy.

The loop is continuous batching over request slots: each slot holds one
sequence and its entry of the per-layer caches; finished slots are
refilled from the queue, and prompts are teacher-forced through decode
steps. As in ``repro``, a refilled slot keeps its predecessor's KV and
recurrent state, and one cache length serves every slot (ROADMAP Queue 3,
R6); the port reproduces this to keep parity. A step runs under
``torch.no_grad()``: serving builds no autograd graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.store import get_pytree
from repro_torch.models.model import Model

__all__ = ["Request", "ServeLoop", "load_params_at"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeLoop:
    """Greedy continuous batching of ``model`` (a :class:`Model` over
    ``cfg``) on the model's device."""

    def __init__(self, cfg: ModelConfig, model: Model, *, batch_slots: int,
                 max_len: int):
        self.cfg = cfg
        self.model = model
        self.B = batch_slots
        self.max_len = max_len
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * batch_slots
        self.caches = model.init_cache(batch_slots, max_len)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                  device=model.device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for i in range(self.B):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                self.active[i] = req
                # prefill by teacher-forcing the prompt through decode
                # steps (batched serving simplification)
                self.tokens[i, 0] = int(req.prompt[0])
                req._pos = 0  # type: ignore[attr-defined]

    @torch.no_grad()
    def step(self) -> int:
        """One decode step for all active slots; returns #finished."""
        self._fill_slots()
        if not any(self.active):
            return 0
        logits, self.caches = self.model.decode_step(self.tokens,
                                                     self.caches)
        # restrict argmax to the real vocab (embedding may be padded)
        nxt_np = logits[:, -1, :self.cfg.vocab_size].argmax(-1).to(
            torch.int32).cpu().numpy()
        finished = 0
        new_tokens = self.tokens.cpu().numpy().copy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            pos = req._pos + 1  # type: ignore[attr-defined]
            if pos < len(req.prompt):
                new_tokens[i, 0] = req.prompt[pos]   # still prefilling
            else:
                req.out.append(int(nxt_np[i]))
                new_tokens[i, 0] = int(nxt_np[i])
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.active[i] = None
                    finished += 1
            req._pos = pos  # type: ignore[attr-defined]
        self.tokens = torch.from_numpy(new_tokens).to(self.model.device)
        return finished

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and not any(self.active):
                break
            self.step()


def load_params_at(client, ref: str, like: Any):
    """Materialize params from a pinned commit/tag (serving read path),
    as CPU tensors in the structure of ``like`` (e.g. a model's
    ``state_dict()``)."""
    snap = client.catalog.read_table(ref, "params")
    return get_pytree(client.store, snap, like)
