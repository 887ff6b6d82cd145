"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis.

The port of ``repro/distributed/pipeline_parallel.py``. Each rank of the
``pipe`` dim holds one stage's parameters, and only those. Microbatches
stream through the stages: at step t stage 0 injects microbatch t, every
live stage applies its block stack, the last stage collects its finished
microbatch, and activations move one rank on (``send``/``recv`` on the
``pipe`` group: neighbour transfers only, no all-gathers), with the
standard (S − 1)/(M + S − 1) bubble. The result is broadcast from the
last stage, so every rank returns the full batch's output, as ``repro``'s
``psum`` of the masked outputs does.

``repro`` runs every stage at every step and masks the dead ones' output;
here a stage skips a step in which it holds no live microbatch (the same
result, without the wasted compute).

A process group whose backend cannot send a CUDA tensor (gloo) gets a
host copy of it: those bytes are counted in ``HOST_COPY_BYTES``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import axis_sizes

__all__ = ["pipeline_forward", "HOST_COPY_BYTES"]

# bytes this process staged through host memory for a gloo transfer of a
# CUDA tensor: {"send": n, "recv": n, "broadcast": n}
HOST_COPY_BYTES = {"send": 0, "recv": 0, "broadcast": 0}


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _shift(y: torch.Tensor, buf: torch.Tensor, rank: int, S: int,
           group) -> torch.Tensor:
    """Send ``y`` to pipe rank ``rank + 1`` and receive the previous
    rank's into a tensor like ``buf`` (a ring: the last rank's output
    reaches stage 0, which never reads it, as ``repro``'s ppermute)."""
    staged = _staged(group, y)
    out = torch.empty_like(buf, device="cpu" if staged else buf.device)
    send = y.detach().cpu() if staged else y.detach().contiguous()
    ops = [dist.P2POp(dist.isend, send, group=group,
                      group_peer=(rank + 1) % S),
           dist.P2POp(dist.irecv, out, group=group,
                      group_peer=(rank - 1) % S)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        HOST_COPY_BYTES["send"] += send.numel() * send.element_size()
        HOST_COPY_BYTES["recv"] += out.numel() * out.element_size()
        out = out.to(buf.device)
    return out


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x: torch.Tensor, *, mesh,
                     num_microbatches: int) -> torch.Tensor:
    """Run x (B, ...) through S pipeline stages with M microbatches.

    ``stage_params`` are this rank's stage's parameters (stage = the
    rank's index on the mesh's ``pipe`` dim); ``stage_fn(params, x)``
    maps a microbatch to one of the same shape. Every rank passes ``x``
    (only stage 0 reads it). Returns the final-stage output for the full
    batch on every rank.
    """
    S = axis_sizes(mesh)["pipe"]
    M = num_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    group = mesh.get_group("pipe")
    rank = mesh.get_local_rank("pipe")
    mb = x.reshape(M, B // M, *x.shape[1:])
    buf = torch.zeros_like(mb[0])
    out = torch.zeros_like(mb)
    for t in range(M + S - 1):
        cur = mb[min(t, M - 1)] if rank == 0 else buf
        live = 0 <= t - rank < M
        y = stage_fn(stage_params, cur) if live else buf
        if rank == S - 1 and 0 <= t - (S - 1) < M:
            out[t - (S - 1)] = y
        if S > 1:
            buf = _shift(y, buf, rank, S, group)
    # the last stage's outputs to every rank
    if S > 1:
        staged = _staged(group, out)
        wire = out.cpu() if staged else out
        dist.broadcast(wire, group=group, group_src=S - 1)
        if staged:
            HOST_COPY_BYTES["broadcast"] += wire.numel() * wire.element_size()
            out = wire.to(x.device)
    return out.reshape(B, *x.shape[1:])
