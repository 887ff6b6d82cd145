"""The program's spans over each cell's traced window, tiny on the CPU.

The program records spans and counters in its model stack under
``repro_torch.obs.tracing()`` (DESIGN.md §14), and with the profiler on
each span is a profiler range; ``repro_torch.obs.device_time.
span_times`` attributes a profile's device time to them. The harness
does not install the recorder yet: these tests trace a cell's window as
its traced branch does (a lead step, then the counted steps), with the
recorder around the counted steps, and hold what a reader of the spans
would find there. Off the card each host operation stands for a device
one.
"""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_port import harness
from bench_port.tests.tiny import CELLS, SEED, tiny_spec
from bench_port.weights import make_weights
from repro_torch import obs
from repro_torch.obs.device_time import span_times

SPANS = {
    "granite-moe-3b.prefill-4x4096": (
        "model.forward", "model.head", "attn.prefill", "moe.route",
        "moe.dispatch", "moe.experts", "moe.combine"),
    "phi4-mini-3b.decode-96x4096": (
        "model.decode_step", "model.head", "attn.decode"),
}


@torch.no_grad()
def _traced(cell):
    spec = tiny_spec(cell)
    ctx = harness.Ctx(spec, SEED, "cpu")
    ctx.model = harness.build_model(ctx.m, make_weights(
        spec.ref.weight_specs(ctx.m), SEED, ctx.device))
    kind = harness.kind_of(spec)
    st = kind.setup(ctx)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kind.window(ctx, st, steps=1)
        start_ns = time.time_ns()
        with obs.tracing() as rec:
            seg = kind.window(ctx, st, steps=spec.traffic["trace_steps"])
    return spec, seg, rec, span_times(prof, SPANS[cell], start_ns,
                                      on_card=False)


@pytest.mark.parametrize("cell", CELLS)
def test_each_span_of_the_cell_is_attributed(cell):
    spec, seg, rec, t = _traced(cell)
    dev = t.device_s
    assert set(dev) == set(SPANS[cell])
    assert all(v > 0 for v in dev.values())
    root = SPANS[cell][0]
    assert len(rec.spans(root)) == seg["steps"]
    # the root holds the window's work: what lies outside it is the
    # benchmark's own (tokens to the host, the judge's samples)
    assert 0.8 * t.busy_s <= dev[root] <= t.busy_s
    assert sum(v for n, v in dev.items() if n != root) <= dev[root]
    assert all(t.idle_s[n] <= t.idle_s[root] for n in dev)
    counters = rec.metrics.snapshot()["counters"]
    m = spec.config["model"]
    if m.get("moe"):
        tr = spec.traffic
        slots = counters["moe.slots"]
        pairs = (seg["steps"] * tr["batch"] * tr["prompt_len"]
                 * m["moe"]["experts_per_token"] * m["num_layers"])
        assert 0 < counters["moe.pairs_kept"] <= min(pairs, slots)
    else:
        assert counters == {}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_under_the_recorder_is_correct(cell):
    """The recorder installed around a whole traced run: the spans change
    none of what the judge reads, and the run reports its metrics."""
    spec = tiny_spec(cell)
    with obs.tracing() as rec:
        out = harness.run(spec, SEED, 0.3, True, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) <= {n for n, _, _ in spec.per_layer}
    assert rec.spans(SPANS[cell][0])
