"""The model stack's spans and counters (``repro_torch.obs``, DESIGN.md
§14), on the CPU at the smoke sizes of granite-moe-3b (a mixture of
experts) and phi4-mini-3b (dense).

Under ``obs.tracing()`` the stack records ``model.forward`` /
``model.decode_step`` at the root, ``model.head``, ``attn.prefill`` /
``attn.decode`` and the MoE's ``moe.route``, ``moe.dispatch``,
``moe.experts`` and ``moe.combine`` under it, the device tally
``moe.pairs_kept`` and the counter ``moe.slots``; with the autograd
profiler on, each span is also a profiler range on the recorder's
clock. Tracing changes no number, and with it off the profiler shows
no range and no tally operation. ``obs.device_time.attribute`` is held
to a synthetic event list whose answer is known exactly.
"""
import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as M
from repro_torch.models.model import Model
from repro_torch.obs.device_time import attribute, span_times

ARCHS = ["granite_moe_3b", "phi4_mini_3b"]
SPANS = ("model.forward", "model.decode_step", "model.head", "attn.prefill",
         "attn.decode", "moe.route", "moe.dispatch", "moe.experts",
         "moe.combine")
MOE_STEPS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
B, S, MAX_LEN = 2, 32, 48


def _model(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    return cfg, model.eval()


def _tokens(cfg, seed=1, shape=(B, S)):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, shape, generator=g)


@torch.no_grad()
def _serve(model, cfg, tokens):
    """A prefill into a fresh cache, then two decode steps: the logits,
    the K/V and the caches as they end."""
    logits, aux, kvs = model(tokens, mode="last_logits", return_kv=True)
    caches = model.init_cache(B, MAX_LEN)
    for cache, (k, v) in zip(caches, kvs):
        cache["attn"]["k"][:, :, :S].copy_(k)
        cache["attn"]["v"][:, :, :S].copy_(v)
        cache["attn"]["len"] = S
    steps = []
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for _ in range(2):
        step, caches = model.decode_step(tok, caches)
        steps.append(step)
        tok = step[:, -1].argmax(-1, keepdim=True)
    return [logits, aux, *[t for kv in kvs for t in kv], *steps,
            *[c["attn"][n] for c in caches for n in ("k", "v")]]


def _parents(rec):
    by_id = {s.span_id: s for s in rec.spans()}
    return [(s.name, by_id[s.parent_id].name if s.parent_id else None)
            for s in sorted(rec.spans(), key=lambda s: (s.t0, s.span_id))]


@pytest.mark.parametrize("arch", ARCHS)
def test_each_span_nests_under_its_entry_point(arch):
    cfg, model = _model(arch)
    L = cfg.num_layers
    moe = cfg.moe is not None
    with torch.no_grad(), obs.tracing() as rec:
        model(_tokens(cfg), mode="last_logits", return_kv=True)
    got = _parents(rec)
    layer = [("attn.prefill", "model.forward")] + (
        [(n, "model.forward") for n in MOE_STEPS] if moe else [])
    assert got == ([("model.forward", None)] + layer * L
                   + [("model.head", "model.forward")])
    assert rec.find("model.forward").attrs == {
        "batch": B, "seq": S, "mode": "last_logits"}

    caches = model.init_cache(B, MAX_LEN)
    with torch.no_grad(), obs.tracing() as rec:
        model.decode_step(_tokens(cfg, shape=(B, 1)), caches)
    layer = [("attn.decode", "model.decode_step")] + (
        [(n, "model.decode_step") for n in MOE_STEPS] if moe else [])
    assert _parents(rec) == ([("model.decode_step", None)] + layer * L
                             + [("model.head", "model.decode_step")])
    assert rec.find("model.decode_step").attrs == {"batch": B,
                                                   "cache_len": 0}


def test_moe_counts_are_the_routing_decisions(monkeypatch):
    """``moe.pairs_kept`` is the number of kept (token, expert) pairs of
    the decisions ``moe.route`` returned, ``moe.slots`` B·E·n·c a
    layer."""
    cfg, model = _model("granite_moe_3b")
    seen, route = [], M.route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        seen.append(out[3])
        return out
    monkeypatch.setattr(M, "route", recorded)
    with torch.no_grad(), obs.tracing() as rec:
        model(_tokens(cfg), mode="last_logits", return_kv=True)
    counters = rec.metrics.snapshot()["counters"]
    n = S // M.group_size(cfg, S)
    assert n > 1
    assert len(seen) == cfg.num_layers
    assert counters["moe.pairs_kept"] == sum(int(k.sum()) for k in seen)
    assert 0 < counters["moe.pairs_kept"] < B * S * cfg.moe.experts_per_token \
        * cfg.num_layers
    assert counters["moe.slots"] == (B * cfg.moe.num_experts * n
                                     * M._capacity(cfg) * cfg.num_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_changes_no_number(arch):
    cfg, model = _model(arch)
    off = _serve(model, cfg, _tokens(cfg))
    with obs.tracing(), profile(activities=[ProfilerActivity.CPU]):
        on = _serve(model, cfg, _tokens(cfg))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _ops(prof) -> collections.Counter:
    return collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events())


@torch.no_grad()
def test_tracing_off_opens_no_range_and_launches_no_tally():
    cfg, model = _model("granite_moe_3b")
    tokens = _tokens(cfg)
    with obs.tracing() as rec:
        model(tokens, mode="last_logits")     # the tally exists from here
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model(tokens, mode="last_logits")
    on = _ops(prof)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(tokens, mode="last_logits")
    off = _ops(prof)
    # the ops of one tally update: a sum of the decisions, added in place
    tally, keep = torch.zeros((), dtype=torch.int64), torch.ones(4) > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tally.add_(keep.sum())
    one = _ops(prof)
    L = cfg.num_layers
    ranges = collections.Counter({"model.forward": 1, "model.head": 1,
                                  "attn.prefill": L,
                                  **{n: L for n in MOE_STEPS}})
    assert not off & ranges
    assert on - off == ranges + collections.Counter(
        {op: L * n for op, n in one.items()})
    assert not off - on


@torch.no_grad()
def test_ranges_start_on_the_recorders_clock():
    """Each span's profiler range starts within 1 ms of its ``t0``: the
    spans and the profiler's events share ``time.time()``."""
    cfg, model = _model("granite_moe_3b")
    with obs.tracing() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        model(_tokens(cfg), mode="last_logits")
        model.decode_step(_tokens(cfg, shape=(B, 1)),
                          model.init_cache(B, MAX_LEN))
    ranges = sorted((e.start_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.name() in SPANS)
    spans = sorted((s.t0, s.name) for s in rec.spans())
    assert [n for _, n in ranges] == [n for _, n in spans]
    assert len(spans) == 2 + 2 + cfg.num_layers * 2 * (1 + len(MOE_STEPS))
    for (ns, _), (t0, _) in zip(ranges, spans):
        assert abs(ns / 1e9 - t0) < 1e-3


def test_begin_commit_spans_are_not_ranges():
    with obs.tracing() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        sp = rec.start_span("run")
        with rec.span("node"):
            torch.ones(2).sum()
        rec.end_span(sp)
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert "node" in names and "run" not in names
    assert [s.name for s in rec.spans()] == ["node", "run"]


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"touched {name}")


def test_device_tally():
    reg = obs.MetricsRegistry()
    assert reg.snapshot() == {"counters": {}, "histograms": {}}
    t = reg.tally("kept")
    assert t.value is None
    t.add(torch.tensor([True, False, True]).sum())
    reg.tally("kept").add(torch.tensor(5))
    reg.counter("slots").inc(12)
    assert t.value.dtype == torch.int64 and t.value.dim() == 0
    assert reg.snapshot()["counters"] == {"slots": 12, "kept": 7}
    obs.NULL_METRICS.tally("kept").add(_Untouchable())
    assert obs.NULL_METRICS.snapshot()["counters"] == {}


# a synthetic window from t = 1000 ns: "outer" holds "inner" on thread 1,
# "other" is open on thread 2 all along
RANGES = [("outer", 1, 1000, 5000), ("inner", 1, 2000, 3000),
          ("other", 2, 1000, 9000)]
OPS = [  # device (begin, end), the launch's (thread, time)
    (900, 1200, 1, 1010),     # begins before the window: left out
    (1100, 1600, 1, 1050),    # outer
    (1800, 2600, 1, 2100),    # outer, inner
    (2400, 3200, 1, 2900),    # outer, inner; overlaps the one before
    (4000, 4500, 2, 1200),    # other
    (7000, 7400, 1, 6000),    # nothing open at its launch
    (7400, 7500, None, 7100),  # no launch found
]


def test_attribution_of_a_synthetic_window():
    t = attribute(RANGES, OPS, start_ns=1000)
    assert t.device_s == {"inner": 1400e-9, "other": 500e-9,
                          "outer": 1900e-9}
    # gaps: 1000-1100, 1600-1800 and 3200-4000 (outer, other), 4500-7000
    # (other)
    assert t.idle_s == {"inner": 0.0, "other": 3600e-9, "outer": 1100e-9}
    assert t.busy_s == pytest.approx(2900e-9, abs=1e-15)


def test_attribution_needs_a_device_operation():
    with pytest.raises(RuntimeError):
        attribute(RANGES, OPS[:1], start_ns=1000)


@torch.no_grad()
def test_span_times_of_a_profiled_prefill():
    """Off the card each host operation stands for a device one: the MoE's
    four steps and attention lie inside ``model.forward``, and nothing
    else runs in the window."""
    cfg, model = _model("granite_moe_3b")
    tokens = _tokens(cfg)
    model(tokens, mode="last_logits")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        start = time.time_ns()
        with obs.tracing():
            model(tokens, mode="last_logits")
    t = span_times(prof, SPANS, start, on_card=False)
    dev = t.device_s
    assert set(dev) == {"model.forward", "model.head", "attn.prefill",
                        *MOE_STEPS}
    assert all(v > 0 for v in dev.values())
    assert sum(dev[n] for n in (*MOE_STEPS, "attn.prefill", "model.head")) \
        <= dev["model.forward"] <= t.busy_s
    assert dev["model.forward"] >= 0.95 * t.busy_s


def test_config_without_experts_counts_nothing():
    cfg, model = _model("phi4_mini_3b")
    with torch.no_grad(), obs.tracing() as rec:
        model(_tokens(cfg), mode="last_logits")
    assert rec.metrics.snapshot()["counters"] == {}
