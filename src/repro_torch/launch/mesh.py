"""Mesh construction.

The port of ``repro/launch/mesh.py``. ``repro``'s mesh is one jit over
many devices; the port's is one program per rank over a
``torch.distributed`` process group. :func:`init_ranks` starts a rank's
process group (a file rendezvous: it needs no free port), and
:func:`make_host_mesh` lays a ``DeviceMesh`` over the ranks of that
group. :func:`run_ranks` starts a group of rank processes and returns
their results, or raises when one fails or the group outlives its time.
The production meshes of the dry-run are :class:`MeshShape`\\ s: names
and sizes only, no processes, since the dry-run reads nothing else.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import MeshShape

__all__ = ["init_ranks", "make_host_mesh", "make_production_mesh",
           "run_ranks"]


def init_ranks(rank: int, world: int, rendezvous_file: str, backend: str,
               *, timeout_s: float = 120.0) -> None:
    """Join the default process group as ``rank`` of ``world``, meeting
    the other ranks at ``rendezvous_file`` (a path on a filesystem they
    share, absent or empty before the first rank starts). ``backend`` is
    named by the caller (``"gloo"``, ``"nccl"``); a collective that
    waits longer than ``timeout_s`` raises."""
    dist.init_process_group(backend, init_method=f"file://{rendezvous_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) single-pod (256 ranks) or (2, 16, 16) two-pod (512)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int | None = None,
                   pipe: int | None = None, device: str = "cuda"):
    """A ``DeviceMesh`` of ``(data, model)``, or ``(pod, data, model)``
    with ``pod``, or ``(pipe,)`` alone with ``pipe``, over the ranks of
    the initialised default group, in rank order. Its tensors live on the
    card unless the caller passes ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    if pipe is not None:
        shape, names = (pipe,), ("pipe",)
    elif pod is not None:
        shape, names = (pod, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {n} "
                         f"ranks; the group has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def _rank_main(fn, rank: int, world: int, rendezvous: str, backend: str,
               args: tuple, out: str, threads: int | None,
               timeout_s: float) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        init_ranks(rank, world, rendezvous, backend, timeout_s=timeout_s)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(fn: Callable, world: int, *args, backend: str,
              timeout_s: float, threads: int | None = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (the
    ``spawn`` start method: a parent that has CUDA up cannot fork), each
    joined to one process group of ``backend`` through a file rendezvous
    in a temporary directory; return their results in rank order.

    ``fn`` and ``args`` are pickled (a module-level function). A rank
    that raises, dies or is still running ``timeout_s`` seconds after
    the start fails the call with ``RuntimeError`` naming it; every rank
    is stopped before this returns or raises. ``threads`` sets each
    rank's CPU threads."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, rdv, backend, args, outs[r],
                                   threads, timeout_s), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            # until all end, one fails (the others may wait on it in a
            # collective forever), or the time is up
            while time.monotonic() < deadline and any(
                    p.is_alive() for p in procs) and not any(
                    p.exitcode not in (None, 0) for p in procs):
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            if late and not failed:
                raise RuntimeError(f"ranks {late} of {world} still running "
                                   f"after {timeout_s} s")
            results = []
            for r in failed + [r for r in range(world) if r not in failed]:
                p, out = procs[r], outs[r]
                if not os.path.exists(out):
                    raise RuntimeError(f"rank {r} of {world} died (exit "
                                       f"code {p.exitcode})")
                with open(out, "rb") as f:
                    status, value = pickle.load(f)
                if status != "ok" or p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {world} failed:\n"
                                       f"{value}")
                results.append(value)
            return results      # no rank failed: in rank order
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
