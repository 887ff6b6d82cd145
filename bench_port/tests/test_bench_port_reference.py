"""The plain reference against the program, on the CPU, at the port's
smoke sizes of both configurations, and the configuration files
against the port's own entries.

Tolerances, each with its reason: the model runs in float32 here, but
the program rounds a MoE layer's dispatched tokens to bfloat16 whatever
the configuration's dtype, and its decode attention reads the cache in
bfloat16; either moves a logit by a few bfloat16 steps (2^-8 relative)
of the activations behind it. The dense prefill is float32 throughout
and differs only in summation order.
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port.reference import decoder as ref
from bench_port.weights import make_weights
from repro_torch.configs import get_config, get_smoke_config

ROOT = Path(__file__).resolve().parents[2]
ARCHS = {"granite-moe-3b": "granite_moe_3b", "phi4-mini-3b": "phi4_mini_3b"}


def smoke(arch: str) -> dict:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    return dataclasses.asdict(cfg)


def program(m: dict, seed: int = 3):
    specs = ref.weight_specs(m)
    return (harness.build_model(m, make_weights(specs, seed, "cpu")),
            make_weights(specs, seed, "cpu"))


def recorded_routing(monkeypatch) -> list:
    from repro_torch.models import moe
    seen, original = [], moe.route

    def recorded(p, xg, cfg):
        out = original(p, xg, cfg)
        seen.append(out[1].transpose(0, 1))
        return out
    monkeypatch.setattr(moe, "route", recorded)
    return seen


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configuration_files_are_the_ports_entries(name):
    conf = json.loads((ROOT / "bench_port" / "configs" / f"{name}.json")
                      .read_text())
    port = dataclasses.asdict(get_config(ARCHS[name]))
    for key, value in conf["model"].items():
        assert port[key] == value, key
    assert port["block_pattern"] == ("attn",) and not port["encoder_layers"]


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_prefill_logits_match_the_program(arch, monkeypatch):
    m = smoke(arch)
    model, W = program(m)
    tokens = torch.randint(0, m["vocab_size"], (2, 48),
                           generator=torch.Generator().manual_seed(1))
    routing = recorded_routing(monkeypatch)
    with torch.no_grad():
        got, _ = model(tokens, mode="logits")
    h, stats = ref.hidden(m, W, tokens,
                          follow=routing if m["moe"] else None)
    want = ref.logits(m, W, h)
    got = got[..., :m["vocab_size"]]
    tol = 2e-2 if m["moe"] else 1e-4
    assert (got - want).abs().max() <= tol * want.abs().max()
    if m["moe"]:
        assert len(routing) == m["num_layers"]
        # float32 routers on the same input choose the same experts in
        # the first layer; behind it the inputs differ by the bfloat16
        # rounding of the dispatched tokens, which can only swap experts
        # whose router logits lie that close
        own = ref.hidden(m, W, tokens)[1]["routing"]
        assert torch.equal(own[0], routing[0])
        assert stats["route_shortfall"] < 1e-2


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_prefill_kv_match_the_program(arch, monkeypatch):
    m = smoke(arch)
    model, W = program(m)
    tokens = torch.randint(0, m["vocab_size"], (2, 48),
                           generator=torch.Generator().manual_seed(4))
    at = torch.tensor([0, 5, 47])
    routing = recorded_routing(monkeypatch)
    with torch.no_grad():
        _, _, kvs = model(tokens, mode="last_logits", return_kv=True)
    _, stats = ref.hidden(m, W, tokens, kv_at=at,
                          follow=routing if m["moe"] else None)
    assert len(stats["kv"]) == len(kvs) == m["num_layers"]
    tol = 2e-2 if m["moe"] else 1e-4
    for (k, v), (wk, wv) in zip(kvs, stats["kv"]):
        for got, want in ((k[:, :, at], wk), (v[:, :, at], wv)):
            assert got.shape == want.shape
            assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_decode_through_the_cache_matches_the_full_forward(arch):
    m = smoke(arch)
    if m["moe"]:
        # a decode step routes one token and never drops; room for every
        # pair makes the full forward drop none either
        m["moe"]["capacity_factor"] = 8.0
    model, W = program(m)
    P, T = 20, 12
    tokens = torch.randint(0, m["vocab_size"], (2, P + T),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, _, kvs = model(tokens[:, :P], mode="last_logits", return_kv=True)
        caches = model.init_cache(2, P + T)
        for cache, (k, v) in zip(caches, kvs):
            cache["attn"]["k"][:, :, :P] = k
            cache["attn"]["v"][:, :, :P] = v
            cache["attn"]["len"] = P
        got = []
        for t in range(P, P + T):
            lg, caches = model.decode_step(tokens[:, t:t + 1], caches)
            got.append(lg[:, 0, :m["vocab_size"]])
    h, _ = ref.hidden(m, W, tokens)
    want = ref.logits(m, W, h[:, P:P + T])
    got = torch.stack(got, 1)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
