"""A configuration whose layers differ, taken as data from files under
``bench_port/tests/`` alone (``mixed.json``, ``mixed_reference.py``):
sliding-window ``local`` blocks beside full ``attn`` ones, with a window
shorter than the prompt, and a mixture of experts with a shared expert.
It runs through ``harness.run`` on the CPU at the tiny prefill cell's
traffic and limits; its own reference declares its parameters."""
import json
import types
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port.reference import decoder
from bench_port.tests import mixed_reference
from bench_port.tests.test_bench_port_imports import top_level_imports
from bench_port.tests.tiny import SEED, tiny_spec

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "mixed.json").read_text())


def mixed_spec(ref=mixed_reference) -> harness.Spec:
    spec = tiny_spec("granite-moe-3b.prefill-4x4096")
    spec.config = json.loads(json.dumps(CONFIG))
    spec.ref = ref
    return spec


def test_the_configuration_is_typed_as_the_program_types_it():
    from repro_torch.configs.base import ModelConfig, MoEConfig
    cfg = harness._typed(ModelConfig, CONFIG["model"])
    assert isinstance(cfg.moe, MoEConfig) and cfg.moe.shared_expert
    assert list(cfg.block_pattern) == ["local", "attn"]
    traffic = mixed_spec().traffic
    assert cfg.local_window < traffic["prompt_len"]
    assert "repro_torch" not in top_level_imports(HERE / "mixed_reference.py")


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_a_clean_run_is_correct(trace):
    out = harness.run(mixed_spec(), SEED, 0.3, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert out["judged"] > 0
    assert set(out["checks"]) == {"served_gap", "logits_rel", "kv_rel",
                                  "route_unrecorded", "route_shortfall"}


def _window_ignored(monkeypatch):
    """Every local block attends to the whole prefix."""
    from repro_torch.models import layers
    original = layers.attention_forward

    def unbounded(*args, kind="attn", **kwargs):
        return original(*args, kind="attn" if kind == "local" else kind,
                        **kwargs)
    monkeypatch.setattr(layers, "attention_forward", unbounded)


def _shared_expert_left_out(monkeypatch):
    """The shared expert adds nothing (every other FFN of the
    configuration is routed, so it is the only MLP)."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "mlp_forward",
                        lambda p, x, cfg: torch.zeros_like(x))


def _altered_logits(monkeypatch):
    """A token altered where it is produced: the logits shifted by one
    place over the vocabulary."""
    from repro_torch.models.model import Model
    original = Model._logits
    monkeypatch.setattr(Model, "_logits", lambda self, x: torch.roll(
        original(self, x), 1, dims=-1))


FAULTS = {"window ignored": _window_ignored,
          "shared expert left out": _shared_expert_left_out,
          "altered token": _altered_logits}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = harness.run(mixed_spec(), SEED, 0.3, False, device="cpu")
    assert not out["correct"], (fault, out["checks"])


def test_the_control_is_not_correct():
    spec = mixed_spec()
    out = harness.run(spec, SEED + 1, 0.3, False, device="cpu",
                      control=True)
    assert out["correct"], out["checks"]
    correct, checks = harness.judge(spec, out["control"])
    assert not correct, checks


def test_without_the_shared_experts_names_the_load_fails_naming_them():
    ref = types.SimpleNamespace(**{
        n: getattr(mixed_reference, n) for n in mixed_reference.__all__})
    ref.weight_specs = decoder.weight_specs
    with pytest.raises(RuntimeError, match=r"Missing key.*layers\.0\.ffn\."
                       r"shared\.w_gate.*layers\.3\.ffn\.shared\.w_down"):
        harness.run(mixed_spec(ref), SEED, 0.3, False, device="cpu")
