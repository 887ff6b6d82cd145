"""Traffic kind ``decode``: batched greedy decode in a closed loop.

Parameters (the traffic file): ``sessions`` prompts of ``prompt_len``
random tokens, drawn from the seed; a ring cache of ``cache_len`` slots
a session (``Model.init_cache``); ``prefill_chunk`` sessions prefilled
at a time in set-up; ``sample_sessions`` sessions and ``sample_steps``
steps judged; ``trace_steps`` steps traced.

Set-up prefills the prompts, ``prefill_chunk`` sessions at a time,
through ``Model.forward(prompts, mode="last_logits", return_kv=True)``,
writes each layer's K/V into slots ``0 .. prompt_len-1`` of the cache,
and takes each session's first token, the argmax of its last logits
over the real vocabulary. The
window then runs ``Model.decode_step`` for all sessions together: each
step's tokens are fed in, and their argmax goes to the host and is fed
back, as the serving loop does. A step runs from feeding its tokens to
the next tokens on the host, timed by the host's clock. The ring
never wraps: after ``cache_len - prompt_len`` steps every session starts
again from the set-up state. Slots below ``prompt_len`` are never
rewritten and a slot past the cache's length is masked, so putting each
cache's length back and feeding the first tokens again restores that
state exactly.

What is judged: every token the sampled sessions were served (their
first and each step's), by the reference run once over the prompt and
those tokens; and the whole logit vector of a reservoir sample, drawn
from the seed, of the steps run (the judge holds those steps' logits).
"""
from __future__ import annotations

import statistics
import time

import torch

from bench_port.weights import generator

__all__ = ["setup", "window", "end_to_end", "judge", "control", "work"]


def setup(ctx) -> dict:
    t, m, model = ctx.traffic, ctx.m, ctx.model
    S, P, L, V = (t["sessions"], t["prompt_len"], t["cache_len"],
                  m["vocab_size"])
    prompts = torch.randint(0, V, (S, P), device=ctx.device,
                            generator=generator(ctx.device, ctx.seed,
                                                "prompts"))
    caches = model.init_cache(S, L)
    first = []
    for lo in range(0, S, t["prefill_chunk"]):
        hi = min(S, lo + t["prefill_chunk"])
        logits, _, kvs = model(prompts[lo:hi], mode="last_logits",
                               return_kv=True)
        for cache, (k, v) in zip(caches, kvs):
            cache["attn"]["k"][lo:hi, :, :P].copy_(k)
            cache["attn"]["v"][lo:hi, :, :P].copy_(v)
        first.append(logits[:, 0, :V].argmax(-1).cpu())
        del logits, kvs
    for cache in caches:
        cache["attn"]["len"] = P
    first = torch.cat(first)
    st = {"prompts": prompts, "base": caches, "first": first,
          "sessions": sorted(ctx.rng.sample(range(S), t["sample_sessions"])),
          "rounds": [[]], "samples": {}, "seen": 0}
    _reset(st)
    # warm the step's shapes, then start again from the set-up state
    _step(ctx, st, record=False)
    _step(ctx, st, record=False)
    _reset(st)
    return st


def _reset(st: dict) -> None:
    st["caches"], st["tokens"], st["pos"] = st["base"], st["first"], 0


def _step(ctx, st: dict, *, record: bool = True):
    """One decode step of every session; its milliseconds on the host's
    clock."""
    V, L = ctx.m["vocab_size"], ctx.traffic["cache_len"]
    if st["pos"] == L - ctx.traffic["prompt_len"]:
        _reset(st)
        st["rounds"].append([])
    begin = time.perf_counter()
    with torch.profiler.record_function("decode.step"):
        tokens = st["tokens"].view(-1, 1).to(ctx.device)
        logits, st["caches"] = ctx.model.decode_step(tokens, st["caches"])
    with torch.profiler.record_function("decode.tokens_to_host"):
        st["tokens"] = logits[:, -1, :V].argmax(-1).cpu()
    ms = 1e3 * (time.perf_counter() - begin)
    st["pos"] += 1
    if record:
        n, keep = st["seen"], ctx.traffic["sample_steps"]
        slot = n if n < keep else ctx.rng.randrange(n + 1)
        if slot < keep:
            st["samples"][slot] = (len(st["rounds"]) - 1, st["pos"] - 1,
                                   logits)
        st["seen"] += 1
        st["rounds"][-1].append(st["tokens"])
    return ms


def window(ctx, st: dict, *, seconds: float | None = None,
           steps: int | None = None) -> dict:
    step_ms, valid = [], []
    n, t0 = 0, time.perf_counter()
    while (steps is None or n < steps) and (
            seconds is None or time.perf_counter() - t0 < seconds):
        step_ms.append(_step(ctx, st))
        valid.append(ctx.traffic["prompt_len"] + st["pos"])
        n += 1
    return {"steps": n, "requests": n * ctx.traffic["sessions"],
            "seconds": time.perf_counter() - t0, "valid": valid,
            "step_ms": step_ms}


def end_to_end(ctx, seg: dict) -> dict:
    p95 = statistics.quantiles(seg["step_ms"], n=20, method="inclusive")[-1]
    return {"decode_tokens_per_s":
            seg["steps"] * ctx.traffic["sessions"] / seg["seconds"],
            "decode_step_p95_ms": p95}


def work(ctx, seg: dict) -> dict:
    """The frozen operation counts of the segment's steps, each at the
    number of valid cache positions it attends over."""
    S = ctx.traffic["sessions"]
    out: dict = {}
    for valid in seg["valid"]:
        for k, v in ctx.flops.decode(ctx.m, S, valid).items():
            out[k] = out.get(k, 0) + v
    return out


def _sequences(st: dict) -> list:
    """(session, rounds, served tokens) to judge: each sampled session's
    first token and what a round served it after that; a round that
    served what an earlier one did, or less, is judged with it."""
    out = []
    for s in st["sessions"]:
        mine = []
        for r, steps in enumerate(st["rounds"]):
            toks = [int(st["first"][s])] + [int(t[s]) for t in steps]
            for rounds, seen in mine:
                if seen[:len(toks)] == toks:
                    rounds.append(r)
                    break
            else:
                mine.append(([r], toks))
        out += [(s, rounds, toks) for rounds, toks in mine]
    return out


def _judge(ctx, st, W, arith):
    """The reference's verdict on what was served, or with ``arith``
    (the control) on what that arithmetic would serve instead."""
    m, P = ctx.m, ctx.traffic["prompt_len"]
    worst = {"served_gap": 0.0, "logits_rel": 0.0}
    by_round = {}
    for r, j, logits in st["samples"].values():
        by_round.setdefault(r, []).append((j, logits))
    count = 0
    for s, rounds, toks in _sequences(st):
        seq = torch.cat([st["prompts"][s],
                         torch.tensor(toks[:-1], device=ctx.device)])
        h, _ = ctx.ref.hidden(m, W, seq[None])
        hc = ctx.ref.hidden(m, W, seq[None], arith)[0] if arith else None
        at = {P + j: lg for r in rounds for j, lg in by_round.get(r, [])}
        served = torch.tensor(toks, device=ctx.device)
        for lo in range(P - 1, P - 1 + len(toks), 256):
            hi = min(P - 1 + len(toks), lo + 256)
            want = ctx.ref.logits(m, W, h[0, lo:hi])
            got = ctx.ref.logits(m, W, hc[0, lo:hi], arith) if arith else None
            pick = (served[lo - P + 1:hi - P + 1] if got is None
                    else got.argmax(-1))
            gap = want.amax(-1) - want.gather(-1, pick[:, None])[:, 0]
            worst["served_gap"] = max(worst["served_gap"], float(gap.max()))
            for pos in range(lo, hi):
                if pos not in at:
                    continue
                g = (at[pos][s, 0, :m["vocab_size"]].float() if got is None
                     else got[pos - lo])
                w = want[pos - lo]
                worst["logits_rel"] = max(worst["logits_rel"],
                                          float((g - w).norm() / w.norm()))
        count += len(toks)
    return worst, count


def judge(ctx, st: dict, W: dict) -> tuple[dict, int]:
    return _judge(ctx, st, W, None)


def control(ctx, st: dict, W: dict) -> dict:
    return _judge(ctx, st, W, ctx.ref.Arith(fp8=True))[0]
