"""The port's mixture of experts (``repro_torch/models/moe.py``) against
``repro``'s (``repro/models/moe.py``), on the CPU.

The same parameters (drawn by ``repro``'s ``moe_init``) and the same
numpy activations go through both ``moe_forward``s, on the granite-moe-3b
(4 experts, top-2 at smoke size) and llama4-scout-17b (top-1 and a shared
expert) smoke configs. The routing decisions are held against ``repro``'s
own routing lines (``_route_group``, ``moe.py:91-101``: the float32
router, ``jax.lax.top_k``, each pair's place in its expert's queue),
run here with JAX on the same inputs.

Tolerances, each with its reason:

- routing decisions (``expert_idx``, ``keep``, slots): equal.
- float32 outputs: rtol = atol = 1e-5. Both sides round the dispatched
  tokens to bfloat16 and take the same products in float32; they differ
  only in summation order.
- bfloat16 outputs: atol 6e-2, as the model tests' bfloat16 logits: the
  expert products round to bfloat16 at other places in the two
  frameworks.
- aux: rtol 1e-6 (a float32 mean of the same probabilities in another
  order; measured equal).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
BF16_TOL = 6e-2
ARCHS = ["granite_moe_3b", "llama4_scout_17b"]


def _t(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _cfgs(arch, moe=None, **over):
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    if moe:
        over["moe"] = dataclasses.replace(jc.moe, **moe)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


def _params(jc, seed=0, zero_router=False):
    p = JM.moe_init(jax.random.PRNGKey(seed), jc)
    if zero_router:
        p = dict(p, router=jnp.zeros_like(p["router"]))
    return p, jax.tree.map(_t, p)


def _x(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtype)


def _jax_route(p, xg, cfg):
    """``repro``'s routing lines (``_route_group``), one (B, g, d) chunk."""
    m = cfg.moe
    B, g, _ = xg.shape
    E, k, c = m.num_experts, m.experts_per_token, JM._capacity(cfg)
    logits = jnp.einsum("bgd,de->bge", xg.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(B, g * k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat,
                  axis=-1).reshape(B, g, k)
    keep = pos < c
    return (np.asarray(expert_idx), np.asarray(keep),
            np.asarray(jnp.where(keep, pos, c)))


def _decisions_match(jp, tp, x, cfg):
    """The port's routing of x (B, S, d) against ``repro``'s, chunk by
    chunk; returns the port's keep mask."""
    B, S, d = x.shape
    g = TM.group_size(cfg, S)
    n = S // g
    xg = _t(x).reshape(B, n, g, d).transpose(0, 1).reshape(n * B, g, d)
    _, idx, pos, keep, _ = TM.route(tp, xg, cfg)
    c = TM._capacity(cfg)
    slot = torch.where(keep, pos, c)
    for i in range(n):
        w_idx, w_keep, w_slot = _jax_route(jp, x[:, i * g:(i + 1) * g], cfg)
        rows = slice(i * B, (i + 1) * B)
        np.testing.assert_array_equal(idx[rows].numpy(), w_idx)
        np.testing.assert_array_equal(keep[rows].numpy(), w_keep)
        np.testing.assert_array_equal(slot[rows].numpy(), w_slot)
    return keep


def _check(jc, tc, jp, tp, x, tol):
    want, waux = JM.moe_forward(jp, x, jc)
    got, gaux = TM.moe_forward(tp, _t(x), tc)
    assert got.dtype == _t(want).dtype and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    assert gaux.dtype == torch.float32 and gaux.shape == ()
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-6)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_repro(arch, dtype):
    over = F32 if dtype == "float32" else {}
    jc, tc = _cfgs(arch, **over)
    jp, tp = _params(jc)
    x = _x((2, 32, jc.d_model), 1, getattr(jnp, dtype))   # two groups of 16
    _decisions_match(jp, tp, x, tc)
    _check(jc, tc, jp, tp, x, 1e-5 if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_group_is_the_largest_divisor_of_s(arch):
    """S = 24 with group_size 16: g = 12, two chunks."""
    jc, tc = _cfgs(arch, **F32)
    assert tc.moe.group_size == 16 and TM.group_size(tc, 24) == 12
    assert [TM.group_size(tc, s) for s in (1, 7, 16, 17, 32, 48)] == \
        [1, 7, 16, 1, 16, 16]
    jp, tp = _params(jc, seed=1)
    x = _x((2, 24, jc.d_model), 2, jnp.float32)
    _decisions_match(jp, tp, x, tc)
    _check(jc, tc, jp, tp, x, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_drops(arch):
    """capacity_factor 0.25: experts overflow their 4 slots, the dropped
    pairs contribute nothing and the surviving gates renormalize."""
    jc, tc = _cfgs(arch, moe=dict(capacity_factor=0.25), **F32)
    assert TM._capacity(tc) == 4
    jp, tp = _params(jc, seed=2)
    x = _x((2, 32, jc.d_model), 3, jnp.float32)
    keep = _decisions_match(jp, tp, x, tc)
    assert not bool(keep.all())
    _check(jc, tc, jp, tp, x, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_pick_the_lowest_experts(arch):
    """A zero router makes every probability 1/E: top-k takes experts 0
    .. k-1 for every token, as jax.lax.top_k does, and the queues fill
    in token order."""
    jc, tc = _cfgs(arch, **F32)
    jp, tp = _params(jc, seed=3, zero_router=True)
    x = _x((2, 32, jc.d_model), 4, jnp.float32)
    keep = _decisions_match(jp, tp, x, tc)
    xg = _t(x).reshape(2, 2, 16, -1).transpose(0, 1).reshape(4, 16, -1)
    _, idx, pos, _, _ = TM.route(tp, xg, tc)
    k = tc.moe.experts_per_token
    assert bool((idx == torch.arange(k)).all())
    assert bool((pos == torch.arange(16)[None, :, None]).all())
    assert bool((keep == (pos < TM._capacity(tc))).all())
    _check(jc, tc, jp, tp, x, 1e-5)


def test_shared_expert_adds_its_mlp():
    jc, tc = _cfgs("llama4_scout_17b", **F32)
    assert tc.moe.shared_expert
    jp, tp = _params(jc, seed=4)
    assert set(tp) == {"router", "experts", "shared"}
    x = _x((1, 16, jc.d_model), 5, jnp.float32)
    with_shared = _check(jc, tc, jp, tp, x, 1e-5)
    alone = {k: v for k, v in tp.items() if k != "shared"}
    without, _ = TM.moe_forward(alone, _t(x), tc)
    from repro_torch.models.layers import mlp_forward
    np.testing.assert_allclose(
        (with_shared - without).numpy(),
        mlp_forward(tp["shared"], _t(x), tc).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_routes_one_token_without_drops(arch):
    """S = 1: g = 1, and the capacity still comes from group_size."""
    jc, tc = _cfgs(arch, moe=dict(capacity_factor=0.25), **F32)
    assert TM._capacity(tc) == 4 and TM.group_size(tc, 1) == 1
    jp, tp = _params(jc, seed=5)
    x = _x((3, 1, jc.d_model), 6, jnp.float32)
    assert bool(_decisions_match(jp, tp, x, tc).all())
    _check(jc, tc, jp, tp, x, 1e-5)


@pytest.mark.parametrize("E,k,group", [(4, 2, 16), (16, 1, 512),
                                       (40, 8, 512), (8, 2, 1),
                                       (128, 8, 64), (3, 3, 7)])
def test_capacity_matches_repro(E, k, group):
    jc, tc = jax_smoke("granite_moe_3b"), get_smoke_config("granite_moe_3b")
    for cf in (0.1, 0.25, 1.0, 1.25, 2.0, 3.7):
        m = dict(num_experts=E, experts_per_token=k, group_size=group,
                 capacity_factor=cf)
        got = TM._capacity(dataclasses.replace(
            tc, moe=dataclasses.replace(tc.moe, **m)))
        want = JM._capacity(dataclasses.replace(
            jc, moe=dataclasses.replace(jc.moe, **m)))
        assert got == want and got % 4 == 0 and got >= 4, (cf, got, want)


def test_full_width_capacities():
    """granite: c = 128 of 512 tokens x 8 slots over 40 experts; llama4:
    c = 40 of 512 x 1 over 16."""
    assert TM._capacity(get_config("granite_moe_3b")) == 128
    assert TM._capacity(get_config("llama4_scout_17b")) == 40


@pytest.mark.parametrize("arch", ARCHS)
def test_module_names_shapes_and_scales(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), d_model=256, d_ff=64,
                              **F32)
    jp = jax.eval_shape(lambda k: JM.moe_init(k, cfg), jax.random.PRNGKey(0))
    module = TM.MoE(cfg, device="cpu")
    got = {n: tuple(p.shape) for n, p in module.named_parameters()}
    want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want
    assert module.router.dtype == torch.float32
    for m in module.modules():
        if isinstance(m, TM.L.ParamModule):
            TM.L.ParamModule.init_params(m, torch.Generator().manual_seed(0))
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    std = {n: float(p.detach().std()) for n, p in module.named_parameters()}
    assert module.experts.w_up.shape == (E, d, f)
    assert abs(std["experts.w_up"] - 1 / math.sqrt(d)) < 5e-3
    assert abs(std["experts.w_down"] - 1 / math.sqrt(f)) < 1e-2
    assert abs(std["router"] - 0.02) < 3e-3


def test_moe_forward_is_repeatable_and_builds_a_graph():
    """The dispatch writes unique indices (no atomics): two calls give the
    same bits; gradients reach the router and every expert weight."""
    jc, tc = _cfgs("granite_moe_3b", **F32)
    _, tp = _params(jc, seed=6)
    x = _t(_x((2, 32, jc.d_model), 7, jnp.float32))
    a, aux_a = TM.moe_forward(tp, x, tc)
    b, aux_b = TM.moe_forward(tp, x, tc)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    leaves = {"router": tp["router"].clone().requires_grad_(True),
              "experts": {k: v.clone().requires_grad_(True)
                          for k, v in tp["experts"].items()}}
    out, aux = TM.moe_forward(leaves, x, tc)
    (out.square().mean() + aux).backward()
    assert float(leaves["router"].grad.abs().max()) > 0
    for v in leaves["experts"].values():
        assert float(v.grad.abs().max()) > 0
