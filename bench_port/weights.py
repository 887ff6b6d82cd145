"""The benchmark's weights and token streams, made from ``--seed``.

Both the program and the reference are handed what this module makes:
the program through ``load_state_dict(..., assign=True)`` into a model
built on ``meta``, the reference by calling it again after the window.
What is drawn is the parameter list that the cell's plain reference
declares (``weight_specs(m)`` of ``bench_port/reference/<reference>.py``:
name -> (shape, dtype, scale), in order, scale None for ones), so a
configuration brings its own list with its reference. The weights are
drawn on the device in the type they are served in, every matrix of a
dtype as a view of one buffer filled by a single ``randn`` call over the
drawn entries in list order and then scaled in place; then the ones.
The same list and seed on the same device give the same bits.
"""
from __future__ import annotations

import hashlib
import math

import torch

__all__ = ["derive", "generator", "make_weights"]


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream (weights, a batch, the prompts),
    from the run's seed and the stream's tags."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


@torch.no_grad()
def make_weights(specs: dict, seed: int, device) -> dict:
    """The state dict of the parameter list ``specs`` (a reference's
    ``weight_specs(m)``) for ``seed``, on ``device``."""
    out = {}
    for dtype in sorted({s[1] for s in specs.values()}, key=str):
        drawn = [(n, s) for n, s in specs.items()
                 if s[1] == dtype and s[2] is not None]
        ones = [(n, s) for n, s in specs.items()
                if s[1] == dtype and s[2] is None]
        total = sum(math.prod(s[0]) for _, s in drawn)
        buf = torch.randn(total, generator=generator(device, seed, "weights",
                                                     dtype),
                          dtype=dtype, device=device)
        at = 0
        for name, (shape, _, scale) in drawn:
            size = math.prod(shape)
            out[name] = buf[at:at + size].view(shape).mul_(scale)
            at += size
        for name, (shape, _, _) in ones:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return out
