"""The port's model stack (``repro_torch/models``) against ``repro``'s.

The same numpy inputs and the same parameters (drawn by ``repro``'s
initializers and carried over with ``convert.params_from_jax``) go
through each layer and the whole model of both packages, on the CPU
(the port's kernels run their plain versions here).

Tolerances, each with its reason:

- float32 layers and the float32 forward: rtol = atol = 1e-4 (measured
  ~1e-6; both sides are float32 and differ only in summation order and
  in the scan's association).
- float32 decode: atol 2e-3. The KV cache is bfloat16 even in a float32
  config (``kv_dtype``), and both sides round their own float32 K/V to
  it; where the two values straddle a rounding boundary, one element
  moves by a bfloat16 step (2^-8 relative). Measured ~3e-4 over 60
  steps.
- bfloat16 config: logits at atol 6e-2 (measured ~2e-2 at logit
  magnitudes ~0.65): the two frameworks round bfloat16 activations at
  different places (``F.gelu``/``F.silu`` round once, XLA per
  operation). With random weights the top two logits of a 256-token
  vocabulary are often closer than that (measured margins down to
  1e-4), so greedy tokens are held to the reference's near-top set: the
  port's choice is within the logit tolerance of the reference's best.
  The same activation differences reach a MoE router: where ``repro``'s
  k-th and (k+1)-th expert probabilities are within ``ROUTE_TIE`` (seen:
  2e-4 and 5e-4 apart), the port may pick the other expert for that
  token. Every MoE layer's routing is recorded on both sides; each
  token routed differently must sit at such a tie, and its logits are
  left out of the 6e-2 comparison (the float32 cases and
  ``test_torch_moe.py`` hold the routing exactly).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models.model import Model, unsupported  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
RG = dict(num_layers=5, local_window=16)      # 2 tail layers, windows crossed
XL = dict(num_layers=4)                       # (mlstm, slstm) x 2
S = 48
DECODE_STEPS = 60
MAX_LEN = 40          # the attn ring wraps within 60 steps; local is 16
BF16_TOL = 6e-2
# a MoE router's k-th and (k+1)-th probabilities closer than this may
# swap between the packages under bfloat16 activations (which differ by
# a bfloat16 step, ~2^-8 relative, at the router's input)
ROUTE_TIE = 2e-3


def _t(x):
    """A numpy or JAX array as a torch tensor (bfloat16 via its bits)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tree(tree):
    return jax.tree.map(_t, tree)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope():
    jc, tc = _cfgs("recurrentgemma_9b", **F32)
    x = _x((2, S, 64), 0)
    scale = _x((64,), 1)
    _close(TL.rmsnorm({"scale": _t(scale)}, _t(x), tc.norm_eps),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                      jc.norm_eps), 1e-5)
    q = _x((2, S, 4, 16), 2)
    pos = np.arange(S)[None, :] + 100
    for dt in (np.float32, jnp.bfloat16):
        want = JL.rope(jnp.asarray(q, dt), jnp.asarray(pos), 10_000.0)
        got = TL.rope(_t(np.asarray(jnp.asarray(q, dt))), _t(pos), 10_000.0)
        _close(got, want, 1e-5 if dt == np.float32 else 1e-2)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "phi4_mini_3b"])
def test_attention_forward_and_return_kv(arch):
    jc, tc = _cfgs(arch, **F32)
    kind = "local" if arch == "recurrentgemma_9b" else "attn"
    p = JL.attention_init(jax.random.PRNGKey(0), jc)
    x = _x((2, S, jc.d_model), 3)
    want, (wk, wv) = JL.attention_forward(p, jnp.asarray(x), jc, kind=kind,
                                          block_q=16, block_kv=16,
                                          return_kv=True)
    got, (gk, gv) = TL.attention_forward(_tree(p), _t(x), tc, kind=kind,
                                         return_kv=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, 1e-4)


def test_full_attention_matches():
    q, k, v = _x((1, 4, 20, 16), 4), _x((1, 2, 20, 16), 5), _x((1, 2, 20, 16),
                                                                6)
    for kw in (dict(), dict(window=5), dict(causal=False, q_offset=3)):
        _close(TL.full_attention(_t(q), _t(k), _t(v), **kw),
               JL.full_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw), 1e-5)


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_attention_decode_ring_buffer(kind):
    """40 single-token steps into a 16-slot cache: the ring wraps twice."""
    arch = "recurrentgemma_9b" if kind == "local" else "phi4_mini_3b"
    jc, tc = _cfgs(arch, **F32)
    p = JL.attention_init(jax.random.PRNGKey(1), jc)
    tp = _tree(p)
    jcache = JL.attention_cache_init(jc, 2, 16)
    tcache = TL.attention_cache_init(tc, 2, 16)
    step = jax.jit(lambda c, x: JL.attention_decode(p, x, c, jc, kind=kind))
    xs = _x((40, 2, 1, jc.d_model), 7)
    for x in xs:
        want, jcache = step(jcache, jnp.asarray(x))
        got, tcache = TL.attention_decode(tp, _t(x), tcache, tc, kind=kind)
        _close(got, want, 2e-3)
    assert tcache["len"] == int(jcache["len"]) == 40
    assert tcache["k"].dtype == torch.bfloat16
    _close(tcache["k"], jcache["k"], 1e-2)
    _close(tcache["v"], jcache["v"], 1e-2)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_forward(act):
    jc, tc = _cfgs("phi4_mini_3b", act=act, **F32)
    p = JL.mlp_init(jax.random.PRNGKey(2), jc)
    x = _x((2, 5, jc.d_model), 8)
    _close(TL.mlp_forward(_tree(p), _t(x), tc),
           JL.mlp_forward(p, jnp.asarray(x), jc), 1e-5)


def test_rglru_conv_gates_and_prefill():
    jc, tc = _cfgs("recurrentgemma_9b", **F32)
    p = JR.rglru_init(jax.random.PRNGKey(3), jc)
    tp = _tree(p)
    x = _x((2, S, 64), 9)
    state = _x((2, 3, 64), 10)
    for st in (None, state):
        want, wtail = JR._causal_conv(jnp.asarray(x), p["conv_w"],
                                      None if st is None else jnp.asarray(st))
        got, gtail = TR._causal_conv(_t(x), tp["conv_w"],
                                     None if st is None else _t(st))
        _close(got, want, 1e-5)
        _close(gtail, wtail, 0)
    for g, w in zip(TR.rglru_gates(tp, _t(x)),
                    JR.rglru_gates(p, jnp.asarray(x))):
        _close(g, w, 1e-5)
    want, _ = jax.jit(lambda x: JR.rglru_forward(p, x, jc))(jnp.asarray(x))
    got, none = TR.rglru_forward(tp, _t(x), tc)
    assert none is None
    _close(got, want, 1e-4)


def test_rglru_decode_steps_and_state_init():
    jc, tc = _cfgs("recurrentgemma_9b", **F32)
    p = JR.rglru_init(jax.random.PRNGKey(4), jc)
    tp = _tree(p)
    jst, tst = JR.rglru_state_init(jc, 2), TR.rglru_state_init(tc, 2)
    for k in ("conv", "h"):
        assert tst[k].shape == jst[k].shape
        assert str(tst[k].dtype).split(".")[1] == str(jst[k].dtype)
    step = jax.jit(lambda s, x: JR.rglru_forward(p, x, jc, s))
    for x in _x((20, 2, 1, 64), 11):
        want, jst = step(jst, jnp.asarray(x))
        got, tst = TR.rglru_forward(tp, _t(x), tc, tst)
        _close(got, want, 1e-4)
    _close(tst["h"], jst["h"], 1e-4)
    _close(tst["conv"], jst["conv"], 1e-4)
    # prefill with a state: the scan wrapper folds h0 into the first step
    x = _x((2, 7, 64), 12)
    want, wst = JR.rglru_forward(p, jnp.asarray(x), jc, jst)
    got, gst = TR.rglru_forward(tp, _t(x), tc, tst)
    _close(got, want, 1e-4)
    _close(gst["h"], wst["h"], 1e-4)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _models(arch, over, seed=0):
    """Both packages' models over ``repro``'s parameters; attention
    biases (zeros at init) are drawn at random, so their use is held."""
    jc, tc = _cfgs(arch, **over)
    jp = JM.init_params(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed + 100)

    def bias(path, leaf):
        if getattr(path[-1], "key", None) in ("bq", "bo"):
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.1,
                               leaf.dtype)
        return leaf

    jp = jax.tree_util.tree_map_with_path(bias, jp)
    model = Model(tc, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tc))
    return jc, tc, jp, model


def _extra(cfg, batch, seed):
    """The front ends' stub inputs, as ``repro``'s ``extra_inputs``
    shapes them: (B, num_source_positions, d_model) frame embeddings for
    an encoder, patch embeddings for a VLM; numpy float32."""
    shape = (batch, cfg.num_source_positions, cfg.d_model)
    if cfg.encoder_layers:
        return {"audio_embeds": _x(shape, seed)}
    if cfg.family == "vlm":
        return {"vision_embeds": _x(shape, seed)}
    return {}


def _jx(extra, dtype=np.float32):
    return {k: jnp.asarray(v, dtype) for k, v in extra.items()}


def _tx(extra, dtype=np.float32):
    return {k: _t(np.asarray(jnp.asarray(v, dtype)))
            for k, v in extra.items()}


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _caches(jc, jp, model, batch, extra):
    """Both packages' decode caches; with an encoder, each layer's cross
    K/V placeholder sized by the encoding of ``extra``'s audio."""
    if not jc.encoder_layers:
        return (JM.init_cache(jc, batch, MAX_LEN),
                model.init_cache(batch, MAX_LEN))
    audio = extra["audio_embeds"]
    jenc = JM.encode(jp, jc, jnp.asarray(audio))
    tenc = model.encode(_t(np.asarray(audio)))
    return (JM.init_cache(jc, batch, MAX_LEN, enc_out=jenc),
            model.init_cache(batch, MAX_LEN, enc_out=tenc))


def _decode_both(jc, jp, model, tokens, extra=None):
    """Teacher-force ``tokens`` (B, T) through both decoders; yields the
    two (B, V) logits of each step."""
    jcache, tcache = _caches(jc, jp, model, tokens.shape[0], extra or {})
    step = jax.jit(lambda c, t: JM.decode_step(jp, jc, t, c))
    for s in range(tokens.shape[1]):
        t = tokens[:, s:s + 1]
        want, jcache = step(jcache, jnp.asarray(t))
        got, tcache = model.decode_step(torch.from_numpy(t), tcache)
        yield got[:, -1], np.asarray(want)[:, -1]


# the model families: every block kind, a mixture of experts (top-2 of
# 4, and top-1 with a shared expert), the audio encoder with cross
# attention, and the VLM's early fusion
MODEL_CASES = [("recurrentgemma_9b", RG), ("phi4_mini_3b", {}),
               ("xlstm_350m", XL), ("granite_moe_3b", {}),
               ("llama4_scout_17b", {}), ("whisper_medium", {}),
               ("phi3_vision_4b", {})]
MODEL_IDS = ["recurrentgemma", "phi4-mini", "xlstm", "granite-moe",
             "llama4", "whisper", "phi3-vision"]


def _aux_matches(got, want, cfg):
    """The summed load-balancing loss: repro's for a MoE (float32 sums
    of the same terms, rtol 1e-6), else 0."""
    assert got.dtype == torch.float32 and got.shape == ()
    if cfg.moe is None:
        assert float(got) == float(want) == 0.0
    else:
        assert float(got) > 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch,over", MODEL_CASES, ids=MODEL_IDS)
@torch.no_grad()            # the model serves: no graph
def test_forward_float32(arch, over):
    jc, tc, jp, model = _models(arch, {**over, **F32})
    tok = _tokens((2, S), 1)
    extra = _extra(tc, 2, 11)
    want, waux = jax.jit(lambda t, e: JM.forward(jp, jc, t, **e))(
        jnp.asarray(tok), _jx(extra))
    got, aux = model(torch.from_numpy(tok), **_tx(extra))
    assert got.dtype == torch.float32
    _aux_matches(aux, waux, tc)
    _close(got, want, 1e-4)
    want_last, _, (kv_scan, kv_tail) = jax.jit(
        lambda t, e: JM.forward(jp, jc, t, mode="last_logits",
                                return_kv=True, **e))(jnp.asarray(tok),
                                                      _jx(extra))
    got_last, _, kvs = model(torch.from_numpy(tok), mode="last_logits",
                             return_kv=True, **_tx(extra))
    assert got_last.shape == (2, 1, tc.padded_vocab)
    _close(got_last, want_last, 1e-4)
    # repro returns K/V per pattern slot, stacked over the scanned repeats,
    # then the tail's; the port one entry per layer
    P, n = jc.pattern_len, jc.n_scan_blocks
    for i, kv in enumerate(kvs):
        kind = jc.block_pattern[i % P]
        if kind not in ("attn", "local"):
            assert kv is None
            continue
        if i < n * P:
            wk, wv = (kv_scan[i % P][k][i // P] for k in ("k", "v"))
        else:
            j = sum(jc.block_pattern[t % P] in ("attn", "local")
                    for t in range(i - n * P))
            wk, wv = kv_tail[j]["k"], kv_tail[j]["v"]
        assert kv[0].shape == (2, jc.num_kv_heads, S, jc.head_dim)
        _close(kv[0], wk, 1e-4)
        _close(kv[1], wv, 1e-4)


@pytest.mark.parametrize("arch,over", MODEL_CASES, ids=MODEL_IDS)
@torch.no_grad()            # the model serves: no graph
def test_decode_steps_float32(arch, over):
    jc, tc, jp, model = _models(arch, {**over, **F32}, seed=1)
    tok = _tokens((2, DECODE_STEPS), 2)
    for got, want in _decode_both(jc, jp, model, tok, _extra(tc, 2, 12)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def _record_routes(monkeypatch) -> dict:
    """Record every MoE layer's routing in both packages, in call order:
    ``repro``'s input and router (its model must run unjitted to give
    them), the port's chosen experts."""
    rec = {"repro": [], "port": []}
    jforward, troute = JMoE.moe_forward, TMoE.route

    def jwrap(p, x, cfg):
        rec["repro"].append((np.asarray(x.astype(jnp.float32)),
                             np.asarray(p["router"])))
        return jforward(p, x, cfg)

    def twrap(p, xg, cfg):
        out = troute(p, xg, cfg)
        rec["port"].append(out[1].numpy())
        return out

    monkeypatch.setattr(JMoE, "moe_forward", jwrap)
    monkeypatch.setattr(TMoE, "route", twrap)
    return rec


def _tied_flips(rec: dict, cfg) -> set:
    """Pairs the calls recorded since the last read. Every token that the
    port routes unlike ``repro`` must sit at a tie of ``repro``'s router
    (k-th and (k+1)-th probabilities within ``ROUTE_TIE``); returns those
    tokens' (b, s)."""
    assert len(rec["repro"]) == len(rec["port"]) > 0
    k = cfg.moe.experts_per_token
    flipped = set()
    for (x, router), idx in zip(rec["repro"], rec["port"]):
        B, S, _ = x.shape
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, router), -1)
        want = np.asarray(jax.lax.top_k(probs, k)[1])
        g = TMoE.group_size(cfg, S)
        got = idx.reshape(S // g, B, g, k).transpose(1, 0, 2, 3).reshape(
            B, S, k)
        for b, s in np.argwhere((got != want).any(-1)):
            p = np.sort(np.asarray(probs[b, s]))[::-1]
            assert p[k - 1] - p[k] < ROUTE_TIE, (b, s, p)
            flipped.add((int(b), int(s)))
    rec["repro"].clear()
    rec["port"].clear()
    return flipped


@pytest.mark.parametrize("arch,over", MODEL_CASES, ids=MODEL_IDS)
@torch.no_grad()            # the model serves: no graph
def test_bfloat16_config_logits_and_greedy_tokens(arch, over, monkeypatch):
    jc, tc, jp, model = _models(arch, over, seed=2)
    assert tc.dtype == tc.param_dtype == "bfloat16"
    assert model.embed.dtype == torch.bfloat16
    moe = tc.moe is not None
    rec = _record_routes(monkeypatch) if moe else None
    # repro runs unjitted where its MoE routing is recorded
    jit = (lambda f: f) if moe else jax.jit
    tok = _tokens((2, S), 3)
    extra = _extra(tc, 2, 13)
    with jax.disable_jit(moe):
        want, waux = jit(lambda t, e: JM.forward(jp, jc, t, **e))(
            jnp.asarray(tok), _jx(extra, jnp.bfloat16))
    got, aux = model(torch.from_numpy(tok), **_tx(extra, jnp.bfloat16))
    same = np.ones((2, S), bool)
    if moe:      # routed from bfloat16 activations
        for b, s in _tied_flips(rec, tc):
            same[b, s] = False
        assert same.mean() > 0.9, same      # ties are rare
        np.testing.assert_allclose(float(aux), float(waux), rtol=BF16_TOL)
    np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                               rtol=0, atol=BF16_TOL)
    # greedy decoding from a prompt, the reference's tokens fed to both
    prompt = _tokens((2, 8), 4)
    jcache, tcache = _caches(jc, jp, model, 2, extra)
    step = jit(lambda c, t: JM.decode_step(jp, jc, t, c))
    nxt = prompt[:, :1]
    for s in range(8 + 16):
        t = prompt[:, s:s + 1] if s < 8 else nxt
        with jax.disable_jit(moe):
            want, jcache = step(jcache, jnp.asarray(t))
        got, tcache = model.decode_step(torch.from_numpy(t), tcache)
        rows = np.ones(2, bool)
        if moe:
            for b, _ in _tied_flips(rec, tc):
                rows[b] = False
        w = np.asarray(want)[rows, -1, :tc.vocab_size]
        g = got[rows, -1, :tc.vocab_size].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_TOL)
        pick = g.argmax(-1)
        assert (w[np.arange(len(w)), pick] >= w.max(-1) - BF16_TOL).all()
        nxt = np.asarray(want)[:, -1, :tc.vocab_size].argmax(-1)[:, None] \
            .astype(np.int32)


def test_params_from_jax_unstacks_layers_in_order():
    jc, tc, jp, model = _models("recurrentgemma_9b",
                                {**RG, **F32, "num_layers": 8})
    sd = model.state_dict()
    # two scanned repeats of (rglru, rglru, local), then two tail layers:
    # layer 3 is the second repeat of pattern slot 0, layer 7 the 2nd tail
    np.testing.assert_array_equal(
        sd["layers.3.mix.w_a"].numpy(),
        np.asarray(jp["slots"][0]["mix"]["w_a"][1]))
    np.testing.assert_array_equal(
        sd["layers.7.mix.proj_out"].numpy(),
        np.asarray(jp["tail"][1]["mix"]["proj_out"]))
    assert [b.kind for b in model.layers] == ["rglru", "rglru", "local"] * 2 \
        + ["rglru", "rglru"]


@torch.no_grad()            # the model serves: no graph
def test_xlstm_forward_crosses_repros_chunk():
    """S = 512: repro scans two chunks of 256 and carries the mLSTM state
    between them; the port's kernel path walks S in its own tiles."""
    jc, tc, jp, model = _models("xlstm_350m", {**XL, **F32}, seed=3)
    tok = _tokens((1, 512), 5)
    want, _ = jax.jit(lambda t: JM.forward(jp, jc, t))(jnp.asarray(tok))
    got, _ = model(torch.from_numpy(tok))
    _close(got, want, 1e-4)


def test_params_from_jax_unstacks_xlstm_slots():
    jc, tc, jp, model = _models("xlstm_350m", {**XL, **F32})
    sd = model.state_dict()
    assert [b.kind for b in model.layers] == ["mlstm", "slstm"] * 2
    # layer 2 is the second repeat of slot 0 (mlstm), layer 3 of slot 1
    for i, slot, rep, names in ((2, 0, 1, ("w_if", "b_if", "wq", "wo")),
                                (3, 1, 1, ("r", "w_in", "b", "w_out")),
                                (1, 1, 0, ("r",))):
        for name in names:
            np.testing.assert_array_equal(
                sd[f"layers.{i}.mix.{name}"].numpy(),
                np.asarray(jp["slots"][slot]["mix"][name][rep]))
    assert "layers.0.mix.r" not in sd and "layers.1.mix.wq" not in sd
    assert sd["layers.1.mix.r"].dtype == torch.float32


def test_init_params_follows_repro_scales():
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma_9b"), **F32)
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert abs(float(sd["embed"].std()) - 0.02) < 2e-3
    assert abs(float(sd["layers.0.mix.w_a"].std()) - 0.01) < 1e-3
    assert abs(float(sd["layers.0.mix.conv_w"].std()) - 0.1) < 3e-2
    assert abs(float(sd["layers.0.mix.proj_gate"].std()) - 64 ** -0.5) < 1e-2
    np.testing.assert_allclose(sd["layers.0.mix.lam"].numpy(),
                               np.linspace(2, 6, 64), rtol=1e-6)
    assert bool((sd["final_norm.scale"] == 1).all())
    again = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(sd.values(), again.state_dict().values()))


def test_full_recurrentgemma_config_on_meta():
    cfg = get_config("recurrentgemma_9b")
    model = Model(cfg, device="meta")
    kinds = [b.kind for b in model.layers]
    assert kinds.count("local") == 12 and kinds.count("rglru") == 26
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert 20e9 < nbytes < 21e9


def test_model_lives_on_the_card_unless_asked_for_the_cpu():
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma_9b"), **F32)
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:   # the default asks for the card, which is absent here
        with pytest.raises((AssertionError, RuntimeError)):
            Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_builds(arch):
    """Every config of ARCHS builds at full size on ``meta``, with as many
    parameters as ``repro``'s tree (``jax.eval_shape``)."""
    cfg = get_config(arch)
    assert unsupported(cfg) is None
    model = Model(cfg, device="meta")
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jax_config(arch)),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want


@pytest.mark.parametrize("arch", ["granite_moe_3b", "whisper_medium"])
def test_params_from_jax_carries_experts_and_the_encoder(arch):
    jc, tc, jp, model = _models(arch, F32)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["embed"].numpy(), np.asarray(jp["embed"]))
    if arch == "granite_moe_3b":
        # one scanned slot: layer 1 is its second repeat; experts stay
        # stacked over E
        ffn = jp["slots"][0]["ffn"]
        E = tc.moe.num_experts
        assert sd["layers.1.ffn.experts.w_gate"].shape == (E, 64, 128)
        for name, want in (("router", ffn["router"][1]),
                           ("experts.w_down", ffn["experts"]["w_down"][1])):
            np.testing.assert_array_equal(sd[f"layers.1.ffn.{name}"].numpy(),
                                          np.asarray(want))
        assert sd["layers.0.ffn.router"].dtype == torch.float32
    else:
        enc = jp["encoder"]
        for i in range(tc.encoder_layers):
            for name in ("attn.wq", "attn.bq", "ffn.w_up", "norm2.scale"):
                a, b = name.split(".")
                np.testing.assert_array_equal(
                    sd[f"encoder.layers.{i}.{name}"].numpy(),
                    np.asarray(enc["layers"][a][b][i]))
        np.testing.assert_array_equal(sd["encoder.final_norm.scale"].numpy(),
                                      np.asarray(enc["final_norm"]["scale"]))
        np.testing.assert_array_equal(
            sd["layers.1.cross.bo"].numpy(),
            np.asarray(jp["slots"][0]["cross"]["bo"][1]))
        assert "layers.0.norm_x.scale" in sd


@torch.no_grad()            # the model serves: no graph
def test_whisper_decode_ignores_the_audio_as_in_repro():
    """R10: nothing fills the cross K/V that init_cache places, so a
    decode step's cross sublayer adds 0 in both packages, and two
    different audio inputs give the same decode logits; the prefill
    reads the audio."""
    jc, tc, jp, model = _models("whisper_medium", F32, seed=4)
    tok = _tokens((2, 12), 5)
    logits = []
    for seed in (20, 21):
        extra = _extra(tc, 2, seed)
        steps = list(_decode_both(jc, jp, model, tok, extra))
        for got, want in steps:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
        logits.append((np.stack([g.numpy() for g, _ in steps]),
                       np.stack([w for _, w in steps]),
                       model(torch.from_numpy(tok), **_tx(extra))[0]))
    (tg0, jw0, pre0), (tg1, jw1, pre1) = logits
    np.testing.assert_array_equal(tg0, tg1)
    np.testing.assert_array_equal(jw0, jw1)
    assert float((pre0 - pre1).abs().max()) > 1e-2


@torch.no_grad()            # the model serves: no graph
def test_vision_embeds_replace_the_first_positions():
    """Early fusion writes the patches over the first P embeddings: the
    tokens' own embeddings given as patches change nothing, other
    patches move every position (each sees them through its past)."""
    jc, tc, jp, model = _models("phi3_vision_4b", F32, seed=5)
    tok = torch.from_numpy(_tokens((1, S), 6))
    P = tc.num_source_positions
    plain, _ = model(tok, mode="hidden")
    same, _ = model(tok, mode="hidden", vision_embeds=model._embed(tok)[:, :P])
    assert torch.equal(same, plain)
    vis = torch.from_numpy(_extra(tc, 1, 22)["vision_embeds"])
    fused, _ = model(tok, mode="hidden", vision_embeds=vis)
    assert float((fused - plain).abs().amax(-1).min()) > 0
