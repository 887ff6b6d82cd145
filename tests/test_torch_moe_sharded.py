"""The port's mixture of experts under ``repro``'s sharding rules, on
gloo ranks on the CPU (``launch.mesh.run_ranks``), against ``repro``'s
single-device model on the same weights (drawn by ``repro``'s
``init_params``, carried over by ``convert.params_from_jax``) and the
same numpy tokens. ``repro``'s own sharded step and dry-run fail on this
JAX (ROADMAP R3, R11), so its single-device model is the oracle, as in
``test_torch_sharded_step.py``.

The smoke granite-moe (4 experts, top-2, group 16) and llama4-scout
(top-1 and a shared expert), float32:

- (a) a prefill forward under ``make_rules("prefill")`` on a (1, 2)
  mesh: expert parallelism, 2 experts a rank;
- (b) one train step under ``make_rules("train", (2, 2),
  seq_parallel=True)`` on 4 ranks: data parallelism over ``data``,
  experts and sequence over ``model``;
- (c) 4 experts on a 3-wide ``model`` axis, d_ff 96: the weights fall
  back to tensor parallelism inside each expert (32 of its ff columns a
  rank), forward and one train step;
- (d) three decode steps under ``make_rules("decode")`` against one
  rank's;
- (e) ``moe_forward`` on ``meta`` tensors;
- (f) the placements of the dispatch's tensors, read where the layer
  tags them, are those the tags resolve to.

Tolerances, each with its reason:

- the MoE layer alone, on the same float32 input, against one rank of
  the port: rtol = atol = 1e-5 (the ranks add their experts' float32
  partial sums; the dispatched tokens are the same).
- the model's logits against one rank of the port and against
  ``repro``: max|diff| within 2^-8 of max|logits|. Every MoE layer
  rounds its dispatched tokens to bfloat16; where two float32
  computations of a layer's input (attention split over heads, or the
  other package) straddle a rounding boundary, a token moves by a
  bfloat16 step and carries it to the layers above
  (``test_torch_train_parity.py``'s MoE bound). One rank of the port is
  4.8e-4 off ``repro`` at granite's seed here, and the two ranks 7.8e-5
  off one rank at llama4's: a float32 bound of 1e-5 holds for neither.
- aux: rtol 1e-5 (the same float32 probabilities summed per rank, then
  added).
- the train step: ``tests/test_multidevice.py``'s bounds, loss 1e-3 and
  parameters rtol 5e-2 / atol 5e-3. Adam's first step moves a parameter
  by about the learning rate whatever its gradient's size, so the
  gradient norm is held too, at rtol 1e-3: a gradient counted twice, or
  missing a rank's share, moves it by far more (``repro``'s float32 step
  takes ``test_torch_train_parity.py``'s rounding barrier, R9).
- decode logits against one rank's: rtol = atol = 1e-5 (the same
  float32 products, summed over the ranks' experts in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.training.train_loop as JT  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

ARCHS = ["granite_moe_3b", "llama4_scout_17b"]
F32 = dict(dtype="float32", param_dtype="float32")
FALLBACK = dict(F32, d_ff=96)       # 96 ff columns split 32 a rank over 3
B, S = 4, 32
LR = 1e-3
LAYER_TOL, MODEL_REL, AUX_RTOL, DECODE_TOL = 1e-5, 2.0 ** -8, 1e-5, 1e-5
LOSS_ATOL, P_RTOL, P_ATOL, NORM_RTOL = 1e-3, 5e-2, 5e-3, 1e-3
DECODE_STEPS = 3
TIMEOUT_S = 240


@jax.custom_vjp
def _barrier(x):
    return x


_barrier.defvjp(lambda x: (x, None),
                lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))


def _cfg(arch, over):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), **over)


def _record(moe, seen: list):
    """Wrap the layer's ``lshard``: each tagged DTensor's names, shape
    and placements, as the tag left it."""
    tag = moe.lshard

    def rec(x, *names):
        y = tag(x, *names)
        if hasattr(y, "placements"):
            seen.append((names, tuple(y.shape), tuple(map(repr,
                                                          y.placements))))
        return y
    moe.lshard = rec


def _forward(cfg, mesh, rules, params, tokens):
    """The model's logits and aux under ``rules``, params resharded."""
    from repro_torch.distributed.elastic import reshard
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import _bind
    shell = Model(cfg, device="meta")
    _bind(shell, reshard(params, mesh, rules))
    with torch.no_grad(), use_rules(rules):
        logits, aux = shell(torch.from_numpy(tokens), mode="logits")
    return logits.full_tensor().numpy(), float(aux.full_tensor())


def _layer(cfg, mesh, rules, params, x):
    """Layer 0's MoE on the float32 x (B, S, d) under ``rules``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.elastic import reshard
    from repro_torch.distributed.sharding import placements, use_rules
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import _bind
    shell = Model(cfg, device="meta")
    _bind(shell, reshard(params, mesh, rules))
    with torch.no_grad(), use_rules(rules):
        xd = distribute_tensor(torch.from_numpy(x), mesh, placements(
            rules.resolve("batch", "seq", "embed"), mesh))
        out, aux = moe.moe_forward(shell.layers[0].ffn, xd, cfg)
    return out.full_tensor().numpy(), float(aux.full_tensor())


def _train_step(cfg, mesh, rules, params, tokens):
    """One sharded train step: (loss, grad_norm, new params whole)."""
    from repro_torch.distributed.elastic import reshard
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_sharded_train_step)
    step = make_sharded_train_step(
        cfg, AdamWConfig(lr=LR, warmup_steps=0, total_steps=100),
        TrainConfig(remat=None, device="cpu"), mesh, rules,
        model=Model(cfg, device="meta"))
    inputs, targets = (torch.from_numpy(t.copy())
                       for t in (tokens[:, :-1], tokens[:, 1:]))
    placed = reshard(params, mesh, rules)
    new_p, _, m = step(placed, reshard(adamw_init(params), mesh, rules),
                       inputs, targets)
    # the update leaves every parameter, the experts' too, where it was
    assert all(new_p[k].placements == v.placements
               for k, v in placed.items())
    return (float(m["loss"].full_tensor()),
            float(m["grad_norm"].full_tensor()),
            {k: v.full_tensor().numpy() for k, v in new_p.items()})


def _decode(cfg, mesh, rules, params, tokens):
    """DECODE_STEPS steps from an empty cache: each step's logits."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.dryrun import _distribute
    from repro_torch.launch.specs import cache_sharding
    from repro_torch.models.model import Model
    from repro_torch.training.train_loop import _bind
    model = Model(cfg, device="cpu")
    caches = model.init_cache(B, 16)
    if rules is not None:
        from repro_torch.distributed.elastic import reshard
        model = Model(cfg, device="meta")
        _bind(model, reshard(params, mesh, rules))
        caches = _distribute(caches, cache_sharding(caches, cfg, mesh,
                                                    rules), mesh)
    else:
        model.load_state_dict(params)
    out = []
    with torch.no_grad(), use_rules(rules):
        for s in range(DECODE_STEPS):
            logits, caches = model.decode_step(
                torch.from_numpy(tokens[:, s:s + 1].copy()), caches)
            out.append(logits.full_tensor().numpy() if rules is not None
                       else logits.numpy())
    return out


def _expert_parallel_ranks(rank, world, cases):
    """(a), (d), (f) on a (1, 2) mesh, for each arch."""
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    mesh = make_host_mesh(1, 2, device="cpu")
    out = {}
    for arch, (params, tokens, x) in cases.items():
        cfg = _cfg(arch, F32)
        seen = []
        tag = moe.lshard
        _record(moe, seen)
        try:
            fwd = _forward(cfg, mesh, make_rules("prefill", mesh), params,
                           tokens)
        finally:
            moe.lshard = tag
        out[arch] = {"forward": fwd, "placements": seen,
                     "layer": _layer(cfg, mesh, make_rules("prefill", mesh),
                                     params, x),
                     "decode": _decode(cfg, mesh, make_rules("decode", mesh),
                                       params, tokens)}
    return out


def _sp_train_ranks(rank, world, cases):
    """(b) on a (2, 2) mesh, for each arch."""
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2, device="cpu")
    rules = make_rules("train", mesh, seq_parallel=True)
    return {arch: _train_step(_cfg(arch, F32), mesh, rules, params, tokens)
            for arch, (params, tokens) in cases.items()}


def _fallback_ranks(rank, world, params, tokens, x):
    """(c) and (f) on a (1, 3) mesh."""
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    cfg = _cfg("granite_moe_3b", FALLBACK)
    mesh = make_host_mesh(1, 3, device="cpu")
    seen = []
    tag = moe.lshard
    _record(moe, seen)
    try:
        fwd = _forward(cfg, mesh, make_rules("prefill", mesh), params,
                       tokens[:, :-1])
    finally:
        moe.lshard = tag
    return {"forward": fwd, "placements": seen,
            "layer": _layer(cfg, mesh, make_rules("prefill", mesh), params,
                            x),
            "step": _train_step(cfg, mesh, make_rules("train", mesh),
                                params, tokens)}


def _oracle(arch, over, seed):
    """repro's parameters, tokens (B, S + 1), float32 forward of the
    first S and one train step."""
    jc = dataclasses.replace(jax_smoke(arch), **over)
    tc = _cfg(arch, over)
    jp = JM.init_params(jax.random.PRNGKey(seed), jc)
    tok = np.random.default_rng(seed).integers(
        0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    logits, aux = JM.forward(jp, jc, jnp.asarray(tok[:, :-1]))
    params = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    from repro_torch.models.model import Model
    one = Model(tc, device="cpu")
    one.load_state_dict(params)
    x = np.random.default_rng(seed + 100).standard_normal(
        (B, S, tc.d_model)).astype(np.float32)
    with torch.no_grad():
        own = one(torch.from_numpy(tok[:, :-1].copy()), mode="logits")[0]
        from repro_torch.models import moe
        layer = moe.moe_forward(one.layers[0].ffn, torch.from_numpy(x), tc)
    opt = JO.AdamWConfig(lr=LR, warmup_steps=0, total_steps=100)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "_bf16_grad_barrier", _barrier)
        p1, _, m = jax.jit(JT.make_train_step(jc, opt, JT.TrainConfig()))(
            jp, JO.adamw_init(jp), tok[:, :-1], tok[:, 1:])
    return {"params": params, "tokens": tok, "one_rank": own.numpy(),
            "x": x, "layer": (layer[0].numpy(), float(layer[1])),
            "logits": np.asarray(logits, np.float32),
            "aux": float(aux), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "new": {k: v.float().numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, p1), tc).items()}}


@pytest.fixture(scope="module")
def oracles():
    return {arch: _oracle(arch, F32, seed) for seed, arch in
            enumerate(ARCHS)}


@pytest.fixture(scope="module")
def expert_parallel(oracles):
    cases = {a: (o["params"], o["tokens"][:, :-1], o["x"]) for a, o in
             oracles.items()}
    return run_ranks(_expert_parallel_ranks, 2, cases, backend="gloo",
                     timeout_s=TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def fallback():
    o = _oracle("granite_moe_3b", FALLBACK, 7)
    return o, run_ranks(_fallback_ranks, 3, o["params"], o["tokens"],
                        o["x"], backend="gloo", timeout_s=TIMEOUT_S,
                        threads=1)


def _check_forward(got, o):
    logits, aux = got
    for want in (o["one_rank"], o["logits"]):
        assert np.abs(logits - want).max() <= MODEL_REL * np.abs(want).max()
    np.testing.assert_allclose(aux, o["aux"], rtol=AUX_RTOL)


def _check_layer(got, o):
    out, aux = got
    np.testing.assert_allclose(out, o["layer"][0], rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(aux, o["layer"][1], rtol=AUX_RTOL)


def _check_step(got, o):
    loss, norm, new = got
    assert abs(loss - o["loss"]) < LOSS_ATOL, (loss, o["loss"])
    np.testing.assert_allclose(norm, o["grad_norm"], rtol=NORM_RTOL)
    assert set(new) == set(o["new"])
    for k, want in o["new"].items():
        np.testing.assert_allclose(new[k], want, rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_prefill_matches_repro(arch, oracles,
                                               expert_parallel):
    for out in expert_parallel:        # every rank holds the whole logits
        _check_forward(out[arch]["forward"], oracles[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_layer_matches_one_rank(arch, oracles,
                                                expert_parallel):
    for out in expert_parallel:
        _check_layer(out[arch]["layer"], oracles[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_train_step_matches_repro(arch, oracles):
    cases = {arch: (oracles[arch]["params"], oracles[arch]["tokens"])}
    for out in run_ranks(_sp_train_ranks, 4, cases, backend="gloo",
                         timeout_s=TIMEOUT_S, threads=1):
        _check_step(out[arch], oracles[arch])


def test_intra_expert_tp_fallback_matches_repro(fallback):
    o, outs = fallback
    for out in outs:
        _check_layer(out["layer"], o)
        _check_forward(out["forward"], o)
        _check_step(out["step"], o)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_one_rank(arch, oracles, expert_parallel):
    o = oracles[arch]
    want = _decode(_cfg(arch, F32), None, None, o["params"],
                   o["tokens"][:, :-1])
    for out in expert_parallel:
        for got, w in zip(out[arch]["decode"], want, strict=True):
            np.testing.assert_allclose(got, w, rtol=DECODE_TOL,
                                       atol=DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_on_meta(arch):
    from repro_torch.models import moe
    cfg = get_smoke_config(arch)
    layer = moe.MoE(cfg, device="meta")
    x = torch.empty(2, 48, cfg.d_model, device="meta",
                    dtype=getattr(torch, cfg.dtype))
    out, aux = moe.moe_forward(layer, x, cfg)
    assert out.device.type == aux.device.type == "meta"
    assert out.shape == x.shape and out.dtype == x.dtype
    assert aux.shape == () and aux.dtype == torch.float32


def _tags(seen):
    return {names: (shape, pl) for names, shape, pl in seen}


def test_dispatch_placements_follow_the_tags(expert_parallel, fallback):
    """Experts over ``model`` and rows over ``data`` under expert
    parallelism; under the fallback the slots stay whole on ``model`` and
    the activations split their ff dim there."""
    from repro_torch.models import moe
    rows, rep = "Shard(dim=0)", "Replicate()"
    for out in expert_parallel:
        for arch in ARCHS:
            cfg = _cfg(arch, F32)
            E = cfg.moe.num_experts
            C = moe._capacity(cfg) * S // moe.group_size(cfg, S)
            tags = _tags(out[arch]["placements"])
            assert tags[("batch", "experts", "expert_cap", "embed")] == (
                (B, E, C, 64), (rows, "Shard(dim=1)"))
            assert tags[("batch", "experts", "expert_cap", "ff")] == (
                (B, E, C, 128), (rows, "Shard(dim=1)"))
            assert tags[("batch", None, "embed")][1] == (rows, rep)
            assert tags[("batch", "seq", "embed")][1] == (rows, rep)
    for out in fallback[1]:
        tags = _tags(out["placements"])
        assert tags[("batch", None, "expert_cap", "embed")][1] == (rows, rep)
        assert tags[("batch", None, "expert_cap", "ff")][1] == (
            rows, "Shard(dim=3)")
