"""Whole runs of each cell at a tiny size on the CPU: the harness's look
for a card skipped, the rest of a run driven (the program's set-up,
window, traced window, the reference's verdict). A clean run is
correct; a run with a fault planted in the timed path is not, and
neither is the control (the float8 reference in the program's place).
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port.tests.tiny import CELLS, SEED, tiny_spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_clean_run_is_correct(cell, trace):
    spec = tiny_spec(cell)
    out = harness.run(spec, SEED, 0.3, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["judged"] > 0
    names = ({n for n, _, _ in spec.per_layer} if trace
             else {n for n, _ in spec.end_to_end})
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert len(out["breakdown"]["device_ops"]) <= 10


def _altered_logits(monkeypatch):
    """A token altered where it is produced: every row's logits shifted
    by one place over the vocabulary (the judge reads a sample of the
    rows)."""
    from repro_torch.models.model import Model
    original = Model._logits

    def altered(self, x):
        out = original(self, x)
        return torch.roll(out, 1, dims=-1)
    monkeypatch.setattr(Model, "_logits", altered)


def _state_unchanged(monkeypatch):
    """A decode step that returns its cache as it found it: nothing
    written, the length not advanced."""
    from repro_torch.models import layers
    original = layers.attention_decode

    def frozen(p, x, cache, cfg, *, kind="attn"):
        k, v = cache["k"].clone(), cache["v"].clone()
        out, _ = original(p, x, cache, cfg, kind=kind)
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        return out, cache
    monkeypatch.setattr(layers, "attention_decode", frozen)


def _altered_kv(monkeypatch):
    """The K/V a prefill hands to a cache altered where they are
    produced: each layer's values moved one position along."""
    from repro_torch.models import layers
    original = layers.attention_forward

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        if not kwargs.get("return_kv"):
            return out
        y, (k, v) = out
        return y, (k, torch.roll(v, 1, dims=2))
    monkeypatch.setattr(layers, "attention_forward", altered)


FAULTS = [(cell, "altered token", _altered_logits) for cell in CELLS] + [
    ("phi4-mini-3b.decode-96x4096", "state unchanged", _state_unchanged)] + [
    (cell, "altered kv", _altered_kv) for cell in CELLS]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c.split('.')[1]}-{f}" for c, f, _ in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, plant,
                                                  monkeypatch):
    plant(monkeypatch)
    out = harness.run(tiny_spec(cell), SEED, 0.3, False, device="cpu")
    assert not out["correct"], (fault, out["checks"])


def test_routing_the_judge_cannot_follow_is_not_correct(monkeypatch):
    """``moe.route`` returning its decisions in another form: the judge
    says so (``route_unrecorded``) instead of failing."""
    from repro_torch.models import moe
    original = moe.route
    monkeypatch.setattr(moe, "route", lambda *a, **k: list(original(*a, **k)))
    out = harness.run(tiny_spec(CELLS[0]), SEED, 0.3, False, device="cpu")
    assert not out["correct"]
    assert out["checks"]["route_unrecorded"]["value"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    spec = tiny_spec(cell)
    out = harness.run(spec, SEED + 1, 0.3, False, device="cpu",
                      control=True)
    assert out["correct"]
    correct, checks = harness.judge(spec, out["control"])
    assert not correct, checks


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_port" / "run.py"), "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.cuda
def test_a_cell_on_the_card_runs_and_is_correct(card):
    out = harness.run(tiny_spec(CELLS[1]), SEED, 0.5, True, device=card)
    assert out["correct"] and out["device"]["platform"] == "gpu"
