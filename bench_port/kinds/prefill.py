"""Traffic kind ``prefill``: the serving prefill in a closed loop.

Parameters (the traffic file): ``batch`` prompts of ``prompt_len``
random tokens each, drawn from the seed per batch; ``sample_batches``,
how many of the batches run are judged; ``kv_positions``, how many
positions of each judged batch's K/V are judged; ``trace_steps``, how
many batches a traced run traces. Batches run back to back, each
through ``Model.forward(tokens, mode="last_logits", return_kv=True)``;
a batch completes when its first tokens (the argmax over the real
vocabulary of each prompt's last logits) are on the host.

The judged batches are a reservoir sample, drawn from the seed, of the
batches run. The judge holds each one's last logits, what each layer
handed to its cache (``kvs``: per layer a tuple of tensors with the
position axis at 2, or None for a layer that caches nothing; each
tensor at ``kv_positions`` positions drawn from the seed, the first and
last among them, into buffers made in set-up) and the router's choice
of every layer the reference's ``routed_layers`` names.

That choice is read through one interface of the program, which a
change to the program has to keep for this judge (or replace by a hook
of its own, with a benchmark change that reads it):
``repro_torch.models.moe.route(p, xg, cfg)`` is looked up in its module
at each call, called once per MoE layer of a forward, and returns a
tuple whose second item is the chosen experts, an integer tensor (n, B,
g, k) of the n groups of g tokens of each sequence. The judge wraps it
for the judged batches alone. Where a judged batch's record lacks that
form, or holds another count than the routed layers, ``route_unrecorded``
reads 1 (limit 0): the run is not correct, and its checks say why.
"""
from __future__ import annotations

import random
import sys
import time

import torch

from bench_port.weights import derive, generator

__all__ = ["setup", "window", "end_to_end", "judge", "control",
           "work"]


def _tokens(ctx, i: int) -> torch.Tensor:
    t = ctx.traffic
    return torch.randint(0, ctx.m["vocab_size"], (t["batch"], t["prompt_len"]),
                         generator=generator(ctx.device, ctx.seed, "batch", i),
                         device=ctx.device)


def _forward(ctx, i: int, keep: dict | None = None):
    """Batch ``i``; for a judged batch, ``keep`` receives its last
    logits, each layer's cache entries at ``keep["kv_pos"]`` (into the
    buffers ``keep["kv"]``, one per tensor, made if absent) and what
    ``moe.route`` returned as each layer's choice."""
    from repro_torch.models import moe
    tokens = _tokens(ctx, i)
    original = moe.route
    if keep is not None:
        routing = keep["routing"] = []

        def recorded(*args, **kwargs):
            out = original(*args, **kwargs)
            routing.append(out[1] if isinstance(out, tuple) and len(out) > 1
                           else None)
            return out
        moe.route = recorded
    try:
        with torch.profiler.record_function("prefill.forward"):
            logits, _, kvs = ctx.model(tokens, mode="last_logits",
                                       return_kv=True)
        with torch.profiler.record_function("prefill.first_tokens"):
            logits[:, 0, :ctx.m["vocab_size"]].argmax(-1).cpu()
    finally:
        moe.route = original
    if keep is not None:
        with torch.profiler.record_function("prefill.judge_sample"):
            at, buf = keep["kv_pos"], keep.get("kv")
            if buf is None:
                buf = keep["kv"] = [None if kv is None else tuple(
                    t.new_empty((*t.shape[:2], len(at), *t.shape[3:]))
                    for t in kv) for kv in kvs]
            for kv, out in zip(kvs, buf):
                for t, o in zip(kv or (), out or ()):
                    torch.index_select(t, 2, at, out=o)
            keep["logits"] = logits
    del kvs


def setup(ctx) -> dict:
    """Warm the one shape the traffic uses with one batch, not judged,
    that takes the judged path; draw the judged K/V positions; make the
    cache entries' buffers for each sample slot (reused when the
    reservoir replaces the slot's batch)."""
    S = ctx.traffic["prompt_len"]
    drawn = random.Random(derive(ctx.seed, "kv_positions")).sample(
        range(1, S - 1), ctx.traffic["kv_positions"] - 2)
    kv_pos = torch.tensor(sorted({0, S - 1, *drawn}), device=ctx.device)
    warm = {"kv_pos": kv_pos}
    _forward(ctx, -1, warm)
    bufs = [warm["kv"]] + [
        [None if kv is None else tuple(torch.empty_like(t) for t in kv)
         for kv in warm["kv"]]
        for _ in range(ctx.traffic["sample_batches"] - 1)]
    return {"next": 0, "samples": {}, "kv_pos": kv_pos, "kv_bufs": bufs}


def window(ctx, st: dict, *, seconds: float | None = None,
           steps: int | None = None) -> dict:
    """Batches back to back for ``seconds`` (the last one finishes) or
    for ``steps`` batches."""
    sample = ctx.traffic["sample_batches"]
    n, t0 = 0, time.perf_counter()
    while (steps is None or n < steps) and (
            seconds is None or time.perf_counter() - t0 < seconds):
        i = st["next"]
        slot = i if i < sample else ctx.rng.randrange(i + 1)
        keep = ({"i": i, "kv_pos": st["kv_pos"], "kv": st["kv_bufs"][slot]}
                if slot < sample else None)
        _forward(ctx, i, keep)
        if keep is not None:
            st["samples"][slot] = keep
        st["next"] += 1
        n += 1
    return {"steps": n, "requests": n * ctx.traffic["batch"],
            "seconds": time.perf_counter() - t0}


def end_to_end(ctx, seg: dict) -> dict:
    t = ctx.traffic
    return {"prefill_tokens_per_s":
            seg["steps"] * t["batch"] * t["prompt_len"] / seg["seconds"]}


def work(ctx, seg: dict) -> dict:
    """The frozen operation counts of the segment's batches."""
    t = ctx.traffic
    one = ctx.flops.prefill(ctx.m, t["batch"], t["prompt_len"])
    return {k: v * seg["steps"] for k, v in one.items()}


def _follow(ctx, routing: list, B: int, S: int) -> list | None:
    """Each routed layer's recorded choice as (B, n, g, k), or None
    where the record lacks the form the judge depends on: one (n, B, g,
    k) integer tensor for each layer of the reference's
    ``routed_layers``."""
    m = ctx.m
    g = ctx.ref.group_size(m, S)
    shape = (S // g, B, g, m["moe"]["experts_per_token"])
    routed = ctx.ref.routed_layers(m)
    if len(routing) != len(routed) or not all(
            isinstance(r, torch.Tensor) and tuple(r.shape) == shape
            and not r.is_floating_point() for r in routing):
        print(f"bench_port: the judged batch's routing was not recorded "
              f"through repro_torch.models.moe.route as (n, B, g, k) = "
              f"{shape} once per routed layer ({len(routed)} layers); the "
              f"judge cannot follow it", file=sys.stderr)
        return None
    return [r.transpose(0, 1) for r in routing]


def _kv_rel(got: list, want: list) -> float:
    """The widest relative L2 gap of one position's cache entry (one
    tensor of one layer and sequence, over every axis but the batch (0)
    and the position (2): all kv heads of a layer's keys, say) against
    the reference's. Each side holds per layer a tuple of tensors, or
    None where the layer caches nothing; a difference in structure (the
    count of layers or of tensors, a shape) reads 1."""
    if len(got) != len(want):
        return 1.0
    worst = 0.0
    for mine, ref in zip(got, want):
        if mine is None or ref is None:
            if mine is not ref:
                return 1.0
            continue
        if len(mine) != len(ref) or any(
                g.shape != w.shape for g, w in zip(mine, ref)):
            return 1.0
        for g, w in zip(mine, ref):
            dims = [a for a in range(w.dim()) if a not in (0, 2)]
            rel = (g.float() - w).norm(dim=dims) / w.norm(dim=dims)
            worst = max(worst, float(rel.max()))
    return worst


def _numbers(ctx, W, tokens, got: dict) -> dict:
    """The reference's verdict on one batch as served: ``got`` holds
    its last logits (B, V), its cache entries at ``kv_pos`` and, where
    the model routes, each routed layer's recorded choice."""
    m = ctx.m
    routed = ctx.ref.routed_layers(m)
    follow = (_follow(ctx, got["routing"], *tokens.shape) if routed
              else None)
    h, stats = ctx.ref.hidden(m, W, tokens, follow=follow,
                              kv_at=got["kv_pos"])
    want = ctx.ref.logits(m, W, h[:, -1])
    served_logits = got["logits"].float()
    served = served_logits.argmax(-1)
    gap = want.amax(-1) - want.gather(-1, served[:, None])[:, 0]
    rel = (served_logits - want).norm(dim=-1) / want.norm(dim=-1)
    out = {"served_gap": float(gap.max()), "logits_rel": float(rel.max()),
           "kv_rel": _kv_rel(got["kv"], stats["kv"])}
    if routed:
        out["route_unrecorded"] = float(follow is None)
        out["route_shortfall"] = stats.get("route_shortfall", 0.0)
    return out


def _worst(rows: list) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def judge(ctx, st: dict, W: dict) -> tuple[dict, int]:
    """The compared numbers over the judged batches, and their count."""
    V = ctx.m["vocab_size"]
    rows = [_numbers(ctx, W, _tokens(ctx, got["i"]),
                     dict(got, logits=got["logits"][:, 0, :V]))
            for got in st["samples"].values()]
    return _worst(rows), len(rows)


def control(ctx, st: dict, W: dict) -> dict:
    """The same numbers of the float8 reference put in the program's
    place, on the judged batches' prompts: it routes by its own router,
    and the float32 judge follows its choice."""
    m, fp8 = ctx.m, ctx.ref.Arith(fp8=True)
    rows = []
    for got in st["samples"].values():
        tokens = _tokens(ctx, got["i"])
        h, stats = ctx.ref.hidden(m, W, tokens, fp8, kv_at=got["kv_pos"])
        rows.append(_numbers(ctx, W, tokens, {
            "logits": ctx.ref.logits(m, W, h[:, -1], fp8),
            "kv": stats["kv"], "kv_pos": got["kv_pos"],
            "routing": [r.transpose(0, 1)
                        for r in stats.get("routing", [])]}))
    return _worst(rows)
