"""The DeepSeek-V2-Lite cell at a tiny size on the CPU, through
``harness.run``: its configuration, reference, flops and metric reader
are files the harness finds by name. Every width is cut, every rule
kept: latent attention with YaRN over fewer original positions than the
prompt holds, a dense first layer, routed experts whose gates are not
renormalized and a shared expert of its own width. A clean run is
correct; a run with one of those rules broken in the program is not, nor
is the control."""
import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port.harness import load_file
from bench_port.tests.tiny import SEED
from bench_port.trace import Trace

CELL = "deepseek-v2-lite.prefill-1x32768"
HERE = Path(__file__).resolve().parents[1]


def deepseek_spec() -> harness.Spec:
    spec = harness.load_spec(CELL)
    m = spec.config["model"]
    m.update(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
             head_dim=16, d_ff=32, vocab_size=300, dense_d_ff=96)
    m["mla"].update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                    v_head_dim=16, rope_original_max_position=32,
                    rope_factor=4.0)
    m["moe"].update(num_experts=8, experts_per_token=2, group_size=16)
    m["shared_d_ff"] = 64
    spec.traffic.update(batch=2, prompt_len=64, sample_batches=2,
                        trace_steps=2)
    return spec


def test_the_configuration_is_the_published_one_as_the_program_types_it():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig, ModelConfig
    conf = json.loads((HERE / "configs" / "deepseek-v2-lite.json")
                      .read_text())
    cfg = harness._typed(ModelConfig, conf["model"])
    assert isinstance(cfg.mla, MLAConfig)
    # the program's own registered configuration, the same to the field
    assert dataclasses.replace(cfg, block_pattern=tuple(
        cfg.block_pattern)) == get_config("deepseek-v2-lite")
    pub = conf["published"]
    assert all(conf[k] == v for k, v in pub.items())
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == (
        pub["num_hidden_layers"], pub["hidden_size"],
        pub["num_attention_heads"], pub["vocab_size"])
    assert (cfg.mla.kv_lora_rank, cfg.mla.qk_nope_head_dim,
            cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) == (
        pub["kv_lora_rank"], pub["qk_nope_head_dim"],
        pub["qk_rope_head_dim"], pub["v_head_dim"])
    yarn = pub["rope_scaling"]
    assert (cfg.mla.rope_factor, cfg.mla.rope_original_max_position,
            cfg.mla.rope_beta_fast, cfg.mla.rope_beta_slow,
            cfg.mla.rope_mscale, cfg.mla.rope_mscale_all_dim) == (
        yarn["factor"], yarn["original_max_position_embeddings"],
        yarn["beta_fast"], yarn["beta_slow"], yarn["mscale"],
        yarn["mscale_all_dim"])
    assert (cfg.d_ff, cfg.dense_d_ff, cfg.first_dense_layers) == (
        pub["moe_intermediate_size"], pub["intermediate_size"],
        pub["first_k_dense_replace"])
    moe = cfg.moe
    assert (moe.num_experts, moe.experts_per_token, cfg.shared_d_ff,
            cfg.norm_topk_prob) == (
        pub["n_routed_experts"], pub["num_experts_per_tok"],
        pub["n_shared_experts"] * pub["moe_intermediate_size"],
        pub["norm_topk_prob"])
    assert cfg.tie_embeddings == pub["tie_word_embeddings"]
    assert cfg.norm_eps == pub["rms_norm_eps"]


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_a_clean_run_is_correct(trace):
    out = harness.run(deepseek_spec(), SEED, 0.3, trace, device="cpu")
    assert out["correct"], out["checks"]
    assert out["judged"] > 0
    assert set(out["checks"]) == {"served_gap", "logits_rel", "kv_rel",
                                  "route_unrecorded", "route_shortfall"}


def _renormalized_gates(monkeypatch):
    """The kept gates renormalized to sum to 1, as norm_topk_prob would."""
    from repro_torch.models import moe
    original = moe.route

    def renormalized(*args, **kwargs):
        probs, idx, pos, keep, gates = original(*args, **kwargs)
        return probs, idx, pos, keep, gates / gates.sum(
            -1, keepdim=True).clamp_min(1e-9)
    monkeypatch.setattr(moe, "route", renormalized)


def _yarn_left_out(monkeypatch):
    """Plain RoPE frequencies and the plain 1/sqrt(qk) scale."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "yarn_inv_freq", lambda cfg, device=None: (
        cfg.rope_theta ** (-torch.arange(0, cfg.mla.qk_rope_head_dim, 2,
                                         dtype=torch.float64, device=device)
                           / cfg.mla.qk_rope_head_dim)))
    monkeypatch.setattr(layers, "mla_softmax_scale",
                        lambda cfg: cfg.mla.qk_head_dim ** -0.5)


def _latent_norm_skipped(monkeypatch):
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "_kv_norm", lambda p, c, eps: c)


FAULTS = {"renormalized gates": _renormalized_gates,
          "yarn left out": _yarn_left_out,
          "latent norm skipped": _latent_norm_skipped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = harness.run(deepseek_spec(), SEED, 0.3, False, device="cpu")
    assert not out["correct"], (fault, out["checks"])


def test_the_control_is_not_correct():
    spec = deepseek_spec()
    out = harness.run(spec, SEED + 1, 0.3, False, device="cpu",
                      control=True)
    assert out["correct"], out["checks"]
    correct, checks = harness.judge(spec, out["control"])
    assert not correct, checks


# one layer of each FFN kind at d 4: 2 heads, r 3, nope 2, rope 2, v 2;
# dense 5, experts of 3 (4, top-2), shared 6; a 250-row vocabulary
SHAPE = dict(num_layers=2, d_model=4, num_heads=2, vocab_size=250, d_ff=3,
             first_dense_layers=1, dense_d_ff=5,
             mla=dict(kv_lora_rank=3, qk_nope_head_dim=2, qk_rope_head_dim=2,
                      v_head_dim=2),
             shared_d_ff=6, moe=dict(num_experts=4, experts_per_token=2))
# per token: q 2*4*(2*4) = 64, kv_a 2*4*5 = 40, kv_b 2*3*(2*4) = 48, out
# 2*(2*2)*4 = 32; dense 3*2*4*5 = 120; MoE router 2*4*4 = 32, two experts
# 2*3*2*4*3 = 144, shared 3*2*4*6 = 144. A live pair and head 2*(4+2) =
# 12, 2 heads: 3 causal pairs in 2 tokens, 2 layers (144). Logits 2*4*256.
PROJ = 64 + 40 + 48 + 32
LAYERS = (PROJ + 120) + (PROJ + 32 + 144 + 144)
# decode per layer: q 64, kv_a 40, q_nope W_uk^T 2*2*2*3 = 24, W_uv
# 2*2*3*2 = 24, out 32; per position 2*2*(3+2) + 2*2*3 = 32
DEC = 2 * (64 + 40 + 24 + 24 + 32) + 120 + 32 + 144 + 144


def test_frozen_counts_match_the_hand_count():
    flops = load_file(HERE / "flops" / "deepseek-v2-lite.py")
    assert flops.prefill(SHAPE, 1, 2) == {
        "total": 2 * LAYERS + 144 + 2048, "flash": 144}
    assert flops.decode(SHAPE, 1, 3) == {"total": DEC + 2 * 3 * 32 + 2048}
    assert flops.prefill(SHAPE, 3, 2)["total"] == 3 * (2 * LAYERS + 144
                                                        + 2048)


def test_the_full_size_count_matches_the_published_shapes():
    flops = load_file(HERE / "flops" / "deepseek-v2-lite.py")
    m = json.loads((HERE / "configs" / "deepseek-v2-lite.json").read_text())[
        "model"]
    one = flops.prefill(m, 1, 32768)
    assert math.isclose(one["total"] / 1e12, 295.344, rel_tol=1e-5)
    assert math.isclose(one["flash"] / 1e12, 148.4386, rel_tol=1e-5)


def test_the_flash_share_reads_the_latent_kernel():
    read = load_file(HERE / "metrics" / "flash_roofline.prefill.py").read
    work = {"total": 3e12, "flash": 989e12 * 0.004}
    ops = [("ampere_bf16_s16816gemm", 0.5, 0.3)]
    assert read(Trace(1.0, 1.0, ops, 1, work)) is None
    ops.append(("(anonymous namespace)::flash_mla_kernel(CUtensorMap, "
                "CUtensorMap)", 0.8, 0.01))
    assert read(Trace(1.0, 1.0, ops, 1, work)) == pytest.approx(40.0)
