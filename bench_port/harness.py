"""Run one cell of the port's benchmark once.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``. A configuration brings, as new
files and entries only:

- its file (``configs``' ``file``): the ``model`` object is the
  program's ``ModelConfig`` as it is run, nested objects included (each
  made the dataclass ``ModelConfig`` types it as); ``reference`` names
  its plain reference;
- the plain reference, ``bench_port/reference/<reference>.py``, which
  exports ``weight_specs(m)`` (the parameter list the weights are drawn
  from: name -> (shape, dtype, scale), in order), ``routed_layers(m)``
  (the layers whose routing the prefill judge follows), ``hidden`` and
  ``logits`` (the forward pass; ``hidden`` reports each layer's cache
  entries as a tuple of tensors with the position axis at 2, or None),
  ``Arith`` (its arithmetic, float8 for the control) and, where it
  routes, ``group_size``;
- its frozen operation counts, ``bench_port/flops/<config>.py``;
- a cell's traffic mix: ``bench_port/traffic/<traffic>.json``, whose
  ``kind`` names the module that runs that kind of traffic,
  ``bench_port/kinds/<kind>.py``;
- the limits of the numbers that decide ``correct``:
  ``bench_port/limits/<cell>.json``;
- each per-layer metric: a reader, ``bench_port/metrics/<name>.py``.

A run: the weights are made on the card from the seed and handed to a
``repro_torch`` model built on ``meta``; the traffic's kind warms the
one shape the cell uses; the window runs for ``seconds`` (or, traced,
a lead step and ``trace_steps`` steps under ``torch.profiler``). Then
the peak memory is read, the program's state is freed, and the plain
reference, handed the same weights made again from the seed, judges
what the window served.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
import typing
from dataclasses import dataclass
from pathlib import Path

import torch

from bench_port.weights import derive, make_weights

__all__ = ["FORBIDDEN", "Spec", "build_model", "forbidden_modules", "judge",
           "load_spec", "run"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names that must not be loaded: the JAX package and JAX
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def load_file(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(
        "bench_port._" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Spec:
    """One cell, as its files give it."""
    cell: str
    config: dict
    traffic: dict
    limits: dict | None
    flops: object
    end_to_end: list        # (name, unit)
    per_layer: list         # (name, unit, reader)
    ref: object             # the configuration's plain reference


def _mine(entries: list, cell: str) -> list:
    return [e for e in entries if cell in e.get("workloads", [cell])]


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    limits = HERE / "limits" / f"{workload}.json"
    config = json.loads((root / conf["file"]).read_text())
    return Spec(
        cell=workload,
        config=config,
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads(limits.read_text()) if limits.exists() else None,
        flops=load_file(HERE / "flops" / f"{w['config']}.py"),
        end_to_end=[(e["name"], e["unit"])
                    for e in _mine(bench["end_to_end"], workload)],
        per_layer=[(e["name"], e["unit"],
                    load_file(HERE / "metrics" / f"{e['name']}.py").read)
                   for e in _mine(bench["per_layer"], workload)],
        ref=importlib.import_module(
            f"bench_port.reference.{config['reference']}"))


def _typed(cls, fields: dict):
    """``cls(**fields)``, each dict that ``cls`` types as a dataclass (or
    as a dataclass or None) made that dataclass, nested ones too."""
    hints = typing.get_type_hints(cls)
    out = dict(fields)
    for name, value in fields.items():
        kinds = typing.get_args(hints[name]) or (hints[name],)
        sub = next((t for t in kinds if dataclasses.is_dataclass(t)), None)
        if isinstance(value, dict) and sub is not None:
            out[name] = _typed(sub, value)
    return cls(**out)


def build_model(m: dict, weights: dict):
    """The program's model of configuration ``m``, holding ``weights``
    (assigned, not copied)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model
    model = Model(_typed(ModelConfig, m), device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return model.eval()


class Ctx:
    """What a traffic kind's module is handed."""

    def __init__(self, spec: Spec, seed: int, device):
        self.m = spec.config["model"]
        self.traffic = spec.traffic
        self.flops = spec.flops
        self.ref = spec.ref
        self.seed = seed
        self.device = torch.device(device)
        self.rng = random.Random(derive(seed, "sample"))
        self.model = None


def kind_of(spec: Spec):
    return importlib.import_module(f"bench_port.kinds.{spec.traffic['kind']}")


def judge(spec: Spec, numbers: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one
    has a limit and is within it."""
    limits = spec.limits or {}
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in sorted(numbers.items())}
    ok = bool(checks) and all(c["limit"] is not None
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@torch.no_grad()
def run(spec: Spec, seed: int, seconds: float, trace: bool,
        device="cuda", t0: float | None = None,
        control: bool = False) -> dict:
    """One run; the result line's object (``checks`` last). With
    ``control``, also the numbers of the control put in the program's
    place on the same inputs (``bench_port/calibrate.py``)."""
    from bench_port import trace as tr
    t0 = time.perf_counter() if t0 is None else t0
    ctx = Ctx(spec, seed, device)
    kind = kind_of(spec)
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    specs = ctx.ref.weight_specs(ctx.m)
    ctx.model = build_model(ctx.m, make_weights(specs, seed, ctx.device))
    st = kind.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        setup_s = time.perf_counter() - t0
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            with profile(activities=acts) as prof:
                kind.window(ctx, st, steps=1)
                start_ns = time.time_ns()
                seg = kind.window(ctx, st, steps=spec.traffic["trace_steps"])
                if on_card:
                    torch.cuda.synchronize()
        else:
            seg = kind.window(ctx, st, seconds=seconds)
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        t = tr.read_profile(prof, start_ns, steps=seg["steps"],
                            work=kind.work(ctx, seg), on_card=on_card)
        del prof
        metrics = {}
        for name, unit, read in spec.per_layer:
            value = read(t)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        values = dict(kind.end_to_end(ctx, seg), setup_s=setup_s)
        metrics = {name: {"value": values[name], "unit": unit}
                   for name, unit in spec.end_to_end}
    # the program's state goes before the reference takes the card
    ctx.model = None
    for key in ("base", "caches"):
        st.pop(key, None)
    _free(ctx.device)
    weights = make_weights(specs, seed, ctx.device)
    numbers, judged = kind.judge(ctx, st, weights)
    correct, checks = judge(spec, numbers)
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": seg["requests"],
           "failed": 0, "metrics": metrics, "device": device_info,
           "judged": judged}
    if trace:
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = tr.breakdown(t)
    if control:
        out["control"] = kind.control(ctx, st, weights)
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
