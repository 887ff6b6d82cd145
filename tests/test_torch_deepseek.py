"""DeepSeek-V2-Lite on the port's normal path, on the CPU at its smoke
sizes, against the benchmark's plain reference
(``bench_port/reference/deepseek_v2.py``), with weights drawn from the
reference's own parameter list.

Tolerances, each with its reason: the model runs in float32 here, but
the program rounds a MoE layer's dispatched tokens to bfloat16 whatever
the configuration's dtype, which moves a logit by a few bfloat16 steps
(2^-8 relative) of the activations behind it: 2e-2 of the logits' norm.
The decode steps read the latent cache, which the float32 smoke model
keeps in bfloat16 (``kv_dtype``): the same 2e-2. Capacity is set so
that no pair is dropped in the decode comparison: a one-token step and
the reference's whole sequence then route each token alike.
"""
import dataclasses
import math

import pytest
import torch

from bench_port.reference import deepseek_v2 as ref
from bench_port.weights import make_weights
from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import Model

ARCH = "deepseek-v2-lite"
TOL = 2e-2


def _smoke(**changes):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                              param_dtype="float32", **changes)
    m = dataclasses.asdict(cfg)
    W = make_weights(ref.weight_specs(m), 5, "cpu")
    model = Model(cfg, device="meta")
    model.load_state_dict(make_weights(ref.weight_specs(m), 5, "cpu"),
                          strict=True, assign=True)
    return cfg, m, W, model.eval()


def _tokens(cfg, B, S, seed=1):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())


def test_the_full_config_builds_at_its_published_size():
    cfg = get_config(ARCH)
    assert round(cfg.num_params() / 1e9, 2) == 15.71
    model = Model(cfg, device="meta")
    # the analytic count leaves the final norm out, for every config
    assert sum(p.numel() for p in model.parameters()) \
        == cfg.num_params() + cfg.d_model
    kinds = [b.routed for b in model.layers]
    assert kinds == [False] + [True] * 26
    assert model.layers[0].ffn.w_gate.shape == (2048, 10944)
    assert model.layers[1].ffn.shared.w_gate.shape == (2048, 2816)
    assert model.layers[1].ffn.experts.w_gate.shape == (64, 2048, 1408)
    assert model.layers[1].mix.wkv_a.shape == (2048, 576)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert 31.3e9 < nbytes < 31.5e9


def test_yarn_and_the_softmax_scale_at_the_published_sizes():
    cfg = get_config(ARCH)
    i = torch.arange(32, dtype=torch.float64)
    extra = 10000.0 ** (-2 * i / 64)
    m = 1 - ((i - 10) / (23 - 10)).clamp(0, 1)
    want = extra / 40 * (1 - m) + extra * m
    torch.testing.assert_close(L.yarn_inv_freq(cfg), want, rtol=1e-12,
                               atol=0)
    assert L.mla_softmax_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    assert L.mla_softmax_scale(cfg) == pytest.approx(
        192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2, rel=1e-12)
    # the reference works the same numbers out on its own
    mdict = dataclasses.asdict(cfg)
    torch.testing.assert_close(ref.inv_freq(mdict), want, rtol=1e-12, atol=0)
    assert ref.softmax_scale(mdict) == pytest.approx(
        L.mla_softmax_scale(cfg), rel=1e-12)


def test_rope_takes_the_published_de_interleaved_layout():
    cfg = get_smoke_config(ARCH)
    x = torch.randn(1, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None]
    got = L.rope_yarn(x, pos, cfg)
    # modeling_deepseek.apply_rotary_pos_emb: view(.., d/2, 2), transpose,
    # reshape; then x cos + rotate_half(x) sin, cos = cat(freqs, freqs)
    y = x.view(1, 5, 2, 4, 2).transpose(-1, -2).reshape(1, 5, 2, 8)
    ang = (pos[..., None].double() * L.yarn_inv_freq(cfg)).float()
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, :, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, :, None]
    rot = torch.cat([-y[..., 4:], y[..., :4]], -1)
    torch.testing.assert_close(got, y * cos + rot * sin)


def test_gates_are_the_raw_probabilities_without_norm_topk_prob():
    cfg = get_smoke_config(ARCH)
    assert not cfg.norm_topk_prob
    g = torch.Generator().manual_seed(2)
    p = {"router": torch.randn(cfg.d_model, cfg.moe.num_experts,
                               generator=g) * 0.5}
    xg = torch.randn(3, 16, cfg.d_model, generator=g)
    probs, idx, pos, keep, gates = M.route(p, xg, cfg)
    torch.testing.assert_close(gates, probs.gather(-1, idx) * keep,
                               rtol=0, atol=0)
    assert float(gates.sum(-1).max()) < 1
    # the default renormalizes, as repro does
    _, _, _, keep, renorm = M.route(p, xg, dataclasses.replace(
        cfg, norm_topk_prob=True))
    torch.testing.assert_close(renorm.sum(-1), torch.ones(3, 16))


@torch.no_grad()
def test_prefill_matches_the_reference(monkeypatch):
    cfg, m, W, model = _smoke()
    tokens = _tokens(cfg, 2, 48)
    routing, original = [], M.route

    def recorded(p, xg, c):
        out = original(p, xg, c)
        routing.append(out[1].transpose(0, 1))
        return out
    monkeypatch.setattr(M, "route", recorded)
    got, _, kvs = model(tokens, mode="logits", return_kv=True)
    # once per routed layer, never for the dense layer 0: the layers the
    # reference names, which the benchmark's prefill judge follows
    assert len(routing) == cfg.num_layers - cfg.first_dense_layers
    assert ref.routed_layers(m) == [1, 2]
    at = torch.tensor([0, 17, 47])
    h, stats = ref.hidden(m, W, tokens, follow=routing, kv_at=at)
    want = ref.logits(m, W, h)
    assert _rel(got[..., :cfg.vocab_size], want) < TOL
    assert stats["route_shortfall"] < 1e-4
    for (c, k_pe), (wc, wk) in zip(kvs, stats["kv"]):
        assert c.shape == (2, 1, 48, 32) and k_pe.shape == (2, 1, 48, 8)
        torch.testing.assert_close(c[:, :, at].float(), wc, rtol=0,
                                   atol=TOL)
        torch.testing.assert_close(k_pe[:, :, at].float(), wk, rtol=0,
                                   atol=TOL)


@torch.no_grad()
def test_prefill_then_decode_through_the_latent_cache():
    """A 24-token prefill written into a 40-slot latent ring by
    ``fill_cache``, then 8 greedy steps; each step's logits against the
    reference's full forward over the prompt and the tokens fed so far
    (its last position). The prompt outruns YaRN's original context."""
    cfg, m, W, model = _smoke(moe=dataclasses.replace(
        get_smoke_config(ARCH).moe, capacity_factor=4.0))
    m["moe"]["capacity_factor"] = 4.0
    B, P = 2, 40
    prompt = _tokens(cfg, B, P)
    logits, _, kvs = model(prompt, mode="last_logits", return_kv=True)
    caches = model.fill_cache(model.init_cache(B, 56), kvs)
    assert all(c["mla"]["len"] == P for c in caches)
    seq = prompt
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    for _ in range(8):
        seq = torch.cat([seq, tok], 1)
        step, caches = model.decode_step(tok, caches)
        h, _ = ref.hidden(m, W, seq)
        want = ref.logits(m, W, h[:, -1])
        assert _rel(step[:, -1, :cfg.vocab_size], want) < TOL
        tok = step[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    assert caches[0]["mla"]["len"] == P + 8


@torch.no_grad()
def test_fill_cache_writes_every_cache_kind():
    """An attention block's (k, v) at slots 0..S-1 of its rows, a local
    ring shorter than the prompt keeping the last positions at slot p
    mod its size."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma_9b"),
                              dtype="float32", param_dtype="float32")
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    S = 24
    _, _, kvs = model(_tokens(cfg, 2, S), mode="last_logits", return_kv=True)
    caches = model.init_cache(3, 40)
    model.fill_cache(caches, kvs, rows=slice(1, 3))
    for layer, cache, kv in zip(model.layers, caches, kvs):
        if kv is None:
            assert "rec" in cache
            continue
        ring = cache["attn"]
        size = ring["k"].shape[2]
        assert ring["len"] == S and not ring["k"][0].any()
        for p in range(S):
            if p >= S - size:
                torch.testing.assert_close(
                    ring["k"][1:, :, p % size], kv[0][:, :, p].to(
                        ring["k"].dtype), rtol=0, atol=0)
        assert size < S or layer.kind != "local"


def test_flash_cpu_path_takes_a_v_head_dim_and_a_scale(monkeypatch):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 2, 9, 24, generator=g)
    k = torch.randn(1, 2, 9, 24, generator=g)
    v = torch.randn(1, 2, 9, 16, generator=g)
    out = ops.flash_attention(q, k, v, causal=True, scale=0.3)
    assert out.shape == (1, 2, 9, 16)
    s = (q @ k.transpose(-1, -2)) * 0.3
    s = s.masked_fill(torch.ones(9, 9).triu(1).bool(), float("-inf"))
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v)
    # the meta count: 2 (qk + v) a live pair and head
    from repro_torch.roofline import analysis
    counted = {}
    monkeypatch.setattr(analysis, "count_kernel_flops",
                        lambda name, flops: counted.__setitem__(name, flops))
    out = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.shape == (1, 2, 9, 16)
    assert counted["flash_attention"] == 2 * (24 + 16) * 45 * 2
    assert kernel.kernel_for(torch.bfloat16, 192, 128) == "mla"
    with pytest.raises(ValueError, match="head dims 192"):
        kernel.kernel_for(torch.float32, 192, 128)


@torch.no_grad()
def test_spans_and_the_cache_counter_under_tracing():
    cfg, m, W, model = _smoke()
    tokens = _tokens(cfg, 2, 32)
    with obs.tracing() as rec:
        _, _, kvs = model(tokens, mode="last_logits", return_kv=True)
        caches = model.fill_cache(model.init_cache(2, 40), kvs)
        model.decode_step(tokens[:, :1], caches)
    L_ = cfg.num_layers
    assert len(rec.spans("attn.prefill")) == L_
    assert len(rec.spans("attn.decode")) == L_
    assert len(rec.spans("mla.project")) == 2 * L_
    assert len(rec.spans("mla.core")) == 2 * L_
    assert len(rec.spans("moe.shared")) == 2 * (L_ - 1)
    a = cfg.mla
    per_token = (a.kv_lora_rank + a.qk_rope_head_dim) * 4     # float32 here
    want = L_ * (2 * 32 * per_token) + L_ * 2 * (a.kv_lora_rank
                                                 + a.qk_rope_head_dim) * 2
    assert rec.metrics.counter("mla.cache_bytes").value == want


@pytest.mark.parametrize("e0,E_l", [(0, 8), (2, 4)])
def test_the_combine_masks_each_pair_by_its_gate(e0, E_l):
    """``_combine`` masks the gates instead of each gathered (n, B, g,
    k, d) pair: the same sums to the bit, drops and other ranks'
    experts included."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                              param_dtype="float32")
    g = torch.Generator().manual_seed(4)
    B, S, d = 2, 64, cfg.d_model
    x = torch.randn(B, S, d, generator=g) + 1
    router = torch.randn(d, cfg.moe.num_experts, generator=g)
    router[:, :2] += 0.5            # most tokens want experts 0 and 1
    gs = M.group_size(cfg, S)
    _, idx, pos, keep, gates = M.route({"router": router},
                                       M._groups(x, gs), cfg)
    assert not bool(keep.all())
    n, c = S // gs, M._capacity(cfg)
    eout = torch.randn(B, E_l, n * c, d, generator=g).to(torch.bfloat16)
    got = M._combine(eout, idx, pos, keep, gates, cfg=cfg, e0=e0)
    own = keep & (idx >= e0) & (idx < e0 + E_l)
    col = torch.arange(n)[:, None, None, None] * c + pos.clamp_max(c - 1)
    picked = eout[torch.arange(B)[None, :, None, None],
                  (idx - e0).clamp(0, E_l - 1), col].float()
    want = torch.einsum("nbgkd,nbgk->nbgd", picked * own[..., None], gates)
    assert torch.equal(got, want.transpose(0, 1).reshape(B, S, d))
