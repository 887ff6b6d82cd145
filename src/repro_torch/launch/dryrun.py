"""Multi-pod dry-run: build and count every (arch × shape × mesh) cell.

The port of ``repro/launch/dryrun.py``, with its command line and its
JSON row keys. For each cell it:

  1. takes the production mesh — (16,16) single-pod or (2,16,16)
     multi-pod — as names and sizes (``launch/mesh.py``);
  2. builds the cell program (train/prefill/serve step) with ``meta``
     arguments and their partition specs (``launch/specs.py``): a spec
     that does not fit, or a step that cannot run under the rules, fails
     the cell;
  3. runs the step once on ``meta`` tensors as rank 0 of a fake process
     group of the mesh's size (``torch.testing._internal.distributed.
     fake_pg``: every collective returns at once, nothing is sent), its
     arguments DTensors with their specs' placements, and counts FLOPs,
     collective operand bytes and the bytes saved for the backward pass
     (``roofline.analysis.analyze_step``);
  4. writes one JSON row per cell under ``--out``.

Where ``repro`` lowers and compiles with XLA, the port has nothing to
compile: ``memory_analysis``, ``lower_s``, ``compile_s``,
``xla_cost_analysis`` and ``while_trips`` say so in the row.
``bytes_per_device`` is exact for the arguments (each leaf's shard),
plus the activations a train step saves for its backward, as the
placements divide them. ``hbm_bytes`` is each argument read once and
each output written once.

Usage:
  python -m repro_torch.launch.dryrun --arch xlstm_350m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed.sharding import MeshShape, placements
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (CellPlan, DryrunKnobs,
                                      arch_dryrun_defaults,
                                      arg_bytes_per_device, build_cell,
                                      skip_reason)
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (StepCost, analyze_step,
                                           roofline_terms)

__all__ = ["run_cell", "trace_cell", "output_bytes", "main"]

NO_COMPILE = "no counterpart: the port runs eagerly and compiles nothing"


def _fake_device_mesh(mesh: MeshShape):
    """A ``DeviceMesh`` of ``mesh``'s shape over a fake process group of
    its size, this process its rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and dist.get_world_size() != mesh.size:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=mesh.size)
    return init_device_mesh("cpu", mesh.sizes,
                            mesh_dim_names=mesh.axis_names)


def _distribute(tree, specs, dmesh):
    """``tree``'s meta tensors as DTensors with ``specs``' placements."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, dmesh, placements(specs, dmesh),
                                 src_data_rank=None)
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], dmesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_distribute(v, s, dmesh)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_distribute(v, s, dmesh)
                          for v, s in zip(tree, specs))
    return tree


def output_bytes(out) -> int:
    """Bytes one rank holds of a step's outputs (a DTensor's local shard)."""
    if isinstance(out, torch.Tensor):
        local = getattr(out, "_local_tensor", out)
        return local.numel() * local.element_size()
    if isinstance(out, dict):
        return sum(output_bytes(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return sum(output_bytes(v) for v in out)
    return 0


def trace_cell(plan: CellPlan, mesh: MeshShape) -> StepCost:
    """Run the plan's step once on ``meta``, as rank 0 of ``mesh``, and
    count it (:func:`~repro_torch.roofline.analysis.analyze_step`)."""
    args = plan.args
    if mesh.size > 1:
        dmesh = _fake_device_mesh(mesh)
        args = tuple(_distribute(a, s, dmesh)
                     for a, s in zip(plan.args, plan.in_shardings))
        # the rules resolve against the device mesh inside the step
        plan_fn = _rebind(plan, dmesh)
    else:
        plan_fn = plan.fn
    grad = plan.kind == "train"
    with torch.set_grad_enabled(grad):
        return analyze_step(plan_fn, *args)


def _rebind(plan: CellPlan, dmesh):
    from repro_torch.distributed.sharding import use_rules
    rules = dataclasses.replace(plan.rules, mesh=dmesh)
    inner = plan.fn.__wrapped__

    def fn(*args):
        with use_rules(rules):
            return inner(*args)
    return fn


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             knobs: DryrunKnobs | None = None,
             save_hlo: str | None = None) -> dict:
    """One cell's row; ``save_hlo`` has no counterpart (there is no HLO)
    and is refused."""
    if save_hlo:
        raise ValueError("--save-hlo: the port has no HLO to save")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size
    knobs = knobs or arch_dryrun_defaults(cfg)
    t0 = time.perf_counter()
    plan = build_cell(cfg, shape, mesh, knobs)
    t_build = time.perf_counter() - t0
    arg_bytes = arg_bytes_per_device(plan, mesh)
    cost = trace_cell(plan, mesh)
    t_trace = time.perf_counter() - t0 - t_build
    bytes_per_device = arg_bytes + cost.saved_bytes

    rl = roofline_terms(
        arch=arch, shape=shape_name, mesh=mesh_kind, chips=chips,
        hlo_flops=cost.flops * chips, model_flops=plan.model_flops,
        hbm_bytes=(arg_bytes + output_bytes(cost.out)) * chips,
        collective_bytes=cost.collective_bytes * chips,
        bytes_per_device=bytes_per_device)
    step_s = max(rl.compute_s, rl.memory_s, rl.collective_s)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "chips": chips,
        "knobs": dataclasses.asdict(knobs),
        "lower_s": NO_COMPILE, "compile_s": NO_COMPILE,
        "build_s": round(t_build, 2), "trace_s": round(t_trace, 2),
        "memory_analysis": NO_COMPILE,
        "argument_bytes_per_device": arg_bytes,
        "saved_activation_bytes_per_device": cost.saved_bytes,
        "bytes_per_device": bytes_per_device,
        "hbm_ok": bytes_per_device < hw.HBM_BYTES,
        "xla_cost_analysis": NO_COMPILE,
        "hlo_flops": rl.hlo_flops,
        "kernel_flops": {k: v * chips for k, v in cost.kernel_flops.items()},
        "model_flops": rl.model_flops,
        "useful_ratio": round(rl.useful_ratio, 4),
        "hbm_bytes": rl.hbm_bytes,
        "collective_bytes": rl.collective_bytes,
        "collective_ops": {k: v * chips
                           for k, v in cost.collective_ops.items()},
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "collective_s": rl.collective_s,
        "bottleneck": rl.bottleneck,
        "roofline_fraction": (rl.compute_s / step_s) if step_s else 0.0,
        "while_trips": "no counterpart: the port's loops run in Python, "
                       "each iteration counted as it runs",
        "counts": "FLOPs: FlopCounterMode on meta plus the kernels' own; "
                  "collectives: traced on rank 0 of a fake process group; "
                  "hbm_bytes: arguments read once, outputs written once",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--save-hlo", default=None)
    ap.add_argument("--fsdp", action="store_true", default=None)
    ap.add_argument("--no-seq-parallel", dest="seq_parallel",
                    action="store_false", default=None)
    ap.add_argument("--remat", default=None,
                    choices=["full", "dots", "none"])
    ap.add_argument("--block-q", type=int, default=None)
    ap.add_argument("--block-kv", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None)
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = ARCHS if args.all else [args.arch]
    shapes = list(SHAPES) if args.all else (
        [args.shape] if args.shape else list(SHAPES))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if not archs[0]:
        ap.error("need --arch or --all")

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                knobs = arch_dryrun_defaults(get_config(arch))
                over = {}
                if args.fsdp is not None:
                    over["fsdp"] = args.fsdp
                if args.seq_parallel is not None:
                    over["seq_parallel"] = args.seq_parallel
                if args.remat is not None:
                    over["remat"] = (None if args.remat == "none"
                                     else args.remat)
                if args.block_q is not None:
                    over["block_q"] = args.block_q
                if args.block_kv is not None:
                    over["block_kv"] = args.block_kv
                if args.accum is not None:
                    over["accum"] = args.accum
                if over:
                    knobs = dataclasses.replace(knobs, **over)
                tag = f"{arch}.{shape}.{mesh_kind}"
                try:
                    row = run_cell(arch, shape, mesh_kind, knobs=knobs,
                                   save_hlo=args.save_hlo)
                except Exception as e:  # a failed cell is a framework bug
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape,
                           "mesh": mesh_kind, "status": "failed",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                (outdir / f"{tag}.json").write_text(json.dumps(row,
                                                               indent=1))
                if row["status"] == "ok":
                    print(f"[dryrun] {tag}: OK  "
                          f"trace={row['trace_s']:.1f}s  "
                          f"bytes/dev={row['bytes_per_device']/2**30:.2f}GiB"
                          f"  bottleneck={row['bottleneck']}  "
                          f"roofline={row['roofline_fraction']:.2f}")
                elif row["status"] == "skipped":
                    print(f"[dryrun] {tag}: SKIP ({row['reason']})")
                else:
                    print(f"[dryrun] {tag}: FAILED {row['error']}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
