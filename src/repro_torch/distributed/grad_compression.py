"""Gradient compression for the slow (inter-pod) all-reduce.

The port of ``repro/distributed/grad_compression.py``. On a multi-pod
mesh the ``pod`` axis crosses links an order of magnitude slower than
those inside a pod. The intra-pod gradient reduction runs at full
precision; only the cross-pod stage is compressed: int8 block-quantized
all-reduce with **error feedback** (the quantization residual is added
to the next step's gradient), which keeps SGD convergence guarantees
(Karimireddy et al., error-feedback SGD).

The wire payload is the int8 tensor + one fp32 scale per 256-block,
~4x fewer bytes than a bf16 all-reduce with an fp32 accumulator. As in
``repro``, the all-reduce below sums the *dequantized* payload so that it
runs on any backend; an int8 all-reduce would carry the int8 wire
format.

``repro`` runs this inside ``shard_map`` over ``pod``; the port is one
program per rank, so each rank holds its pod's gradient and the
all-reduce runs on the ``pod`` dim's process group.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import axis_names, axis_sizes

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_pod",
           "psum_mean"]


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization of the flattened tensor:
    (q (n_blocks, block) int8, scale (n_blocks, 1) float32)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, size: int,
                    shape) -> torch.Tensor:
    out = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return out.reshape(shape)


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _like(x, local):
    """``local`` as ``x`` is: a DTensor with ``x``'s placements, or the
    plain tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return DTensor.from_local(local, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return local


def _leaf_compressed_psum(g: torch.Tensor, e: torch.Tensor, npod: int,
                          block: int, group) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """One leaf: quantize (+ error feedback), all-reduce, dequantize."""
    import torch.distributed as dist
    gf = g.to(torch.float32) + e
    q, scale = quantize_int8(gf, block)
    local_deq = dequantize_int8(q.to(torch.int32), scale, gf.numel(),
                                gf.shape)
    new_e = gf - local_deq            # residual kept for next step
    payload = q.to(torch.float32) * scale
    dist.all_reduce(payload, group=group)
    deq = payload.reshape(-1)[:gf.numel()].reshape(gf.shape) / npod
    return deq.to(g.dtype), new_e


def compressed_psum_pod(grads: dict, mesh, *, error: dict | None = None,
                        block: int = 256) -> tuple[dict, dict]:
    """All-reduce ``grads`` ({name: tensor}) over the ``pod`` axis of
    ``mesh`` with int8 compression + error feedback. Returns
    (reduced_grads, new_error): the mean over the pods of each leaf, and
    each rank's float32 residual.

    Each rank passes its pod's gradient (the intra-pod reduction already
    done): a plain tensor, or a DTensor not partial over ``pod``, whose
    local shard is reduced. Without a ``pod`` axis the gradients pass
    through.
    """
    if "pod" not in axis_names(mesh):
        return grads, (error if error is not None else
                       {k: torch.zeros(g.shape, dtype=torch.float32,
                                       device=g.device)
                        for k, g in grads.items()})
    npod = axis_sizes(mesh)["pod"]
    group = mesh.get_group("pod")
    red, new_err = {}, {}
    for k, g in grads.items():
        gl = _local(g)
        e = (torch.zeros(gl.shape, dtype=torch.float32, device=gl.device)
             if error is None else _local(error[k]))
        r, ne = _leaf_compressed_psum(gl, e, npod, block, group)
        red[k], new_err[k] = _like(g, r), _like(g, ne)
    return red, new_err


def psum_mean(grads: dict, mesh, axis: str) -> dict:
    """The plain (uncompressed) mean of ``grads`` over the ``axis`` dim of
    ``mesh``: the all-reduce the compressed one replaces."""
    import torch.distributed as dist
    n = axis_sizes(mesh)[axis]
    group = mesh.get_group(axis)
    out = {}
    for k, g in grads.items():
        s = _local(g).to(torch.float32).clone()
        dist.all_reduce(s, group=group)
        out[k] = _like(g, (s / n).to(g.dtype))
    return out
