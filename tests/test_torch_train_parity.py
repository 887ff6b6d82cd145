"""One train step of the port (``repro_torch/training``) against
``repro``'s, on the CPU, on the float32 smoke configs of xlstm-350m,
recurrentgemma-9b and phi4-mini-3b.

The same numpy batch and the same parameters (drawn by ``repro``'s
initializer, carried over by ``convert.params_from_jax``, which maps a
gradient tree the same way) go through ``repro``'s jitted step and the
port's, with accumulation over 1, 2 and 4 microbatches and with each
remat mode.

``repro`` cannot take a float32 step as it stands (fault R9 in
ROADMAP.md): its gradient barrier hands a bfloat16 cotangent to the
float32 model, and JAX's multiply refuses the mixed dtypes. The port's
barrier rounds the cotangent to bfloat16 and continues in float32; the
reference here is ``repro``'s step with a barrier that does the same
(``_barrier`` below), so both sides compute the same function. A test
pins the fault.

Tolerances, each with its reason (measured values from this file's
cases in brackets):

- loss, ``ce``, ``z``, ``aux``, the learning rate: rtol 1e-6 (both
  float32; [2e-7]).
- ``grad_norm``: rtol 1e-5 (a sum of squares over every leaf in another
  order; [1e-6]).
- each gradient leaf, max|port - repro| / max|repro| per leaf: 5e-4. The
  attention of recurrentgemma and phi4-mini differentiates through the
  whole softmax on the port and through ``repro``'s tile-recomputing
  flash backward ([1.1e-4]); the recurrences in another order
  ([1e-6]).
- each updated parameter: 1e-5 absolute where the leaf's gradient is
  at least 1e-6 in magnitude. Adam's first step moves a parameter by
  lr * g / (|g| + eps), so where |g| is within a few eps (1e-8) of zero
  the update hangs on g's last digits: there it may differ by up to
  2 * lr, its bound, and is held to that ([2.2e-4 at g ~ 1.6e-8]).
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
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_loop as TT  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ["xlstm_350m", "recurrentgemma_9b", "phi4_mini_3b"]
B, S = 4, 32
LR = 1e-3
GRAD_REL, UPDATE_ABS, WELL_CONDITIONED = 5e-4, 1e-5, 1e-6
VARIANTS = [(1, None), (2, None), (4, None), (1, "full"), (1, "dots")]


@jax.custom_vjp
def _barrier(x):
    return x


_barrier.defvjp(lambda x: (x, None),
                lambda _, g: (g.astype(jnp.bfloat16).astype(g.dtype),))


@pytest.fixture(autouse=True)
def _rounding_barrier(monkeypatch):
    monkeypatch.setattr(JT, "_bf16_grad_barrier", _barrier)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _opt():
    kw = dict(lr=LR, warmup_steps=0, total_steps=100)
    return JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """repro's parameters, batch and its gradients of the loss, mapped
    onto the port's names."""
    arch = request.param
    jc = dataclasses.replace(jax_smoke(arch), **F32)
    tc = dataclasses.replace(get_smoke_config(arch), **F32)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tok = np.random.default_rng(1).integers(
        0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    inputs, targets = tok[:, :-1], tok[:, 1:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JT, "_bf16_grad_barrier", _barrier)
        (loss, parts), grads = jax.jit(jax.value_and_grad(
            lambda p: JT.loss_fn(p, jc, inputs, targets, z_loss=1e-4,
                                 aux_weight=1e-2), has_aux=True))(jp)
    return {"arch": arch, "jc": jc, "tc": tc, "jp": jp, "inputs": inputs,
            "targets": targets, "loss": float(loss),
            "parts": {k: float(v) for k, v in parts.items()},
            "grads": params_from_jax(grads, tc),
            "params": params_from_jax(jp, tc)}


def _torch_batch(case):
    return (torch.from_numpy(case["inputs"].copy()),
            torch.from_numpy(case["targets"].copy()))


@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_loss_and_every_gradient_match_repro(case, remat):
    tcfg = TT.TrainConfig(remat=remat, device="cpu")
    (loss, parts), grads = TT.make_grad_fn(case["tc"], tcfg)(
        case["params"], *_torch_batch(case))
    np.testing.assert_allclose(float(loss), case["loss"], rtol=1e-6)
    for k, v in case["parts"].items():
        np.testing.assert_allclose(float(parts[k]), v, rtol=1e-6, atol=1e-9)
    assert set(grads) == set(case["grads"])
    for name, want in case["grads"].items():
        got = grads[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        err = np.abs(_np(got) - _np(want)).max() / np.abs(_np(want)).max()
        assert err <= GRAD_REL, (name, err)


@pytest.mark.parametrize("accum,remat", VARIANTS,
                         ids=[f"accum{a}-{r}" for a, r in VARIANTS])
def test_train_step_matches_repro(case, accum, remat):
    jopt, topt = _opt()
    jtc = JT.TrainConfig(accum=accum, remat=remat)
    jp, jo, jm = jax.jit(JT.make_train_step(case["jc"], jopt, jtc))(
        case["jp"], JO.adamw_init(case["jp"]), case["inputs"],
        case["targets"])
    tparams = case["params"]
    tp, to, tm = TT.make_train_step(
        case["tc"], topt, TT.TrainConfig(accum=accum, remat=remat,
                                         device="cpu"))(
        tparams, TO.adamw_init(tparams), *_torch_batch(case))
    for k in ("loss", "ce", "z", "aux", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert int(to.step) == int(jo.step) == 1
    want_p = params_from_jax(jp, case["tc"])
    for name, want in want_p.items():
        got = tp[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        diff = np.abs(_np(got) - _np(want))
        sharp = np.abs(_np(case["grads"][name])) >= WELL_CONDITIONED
        assert diff[sharp].max(initial=0) <= UPDATE_ABS, name
        assert diff.max() <= 2 * LR, name
    for tree, jtree in ((to.mu, jo.mu), (to.nu, jo.nu)):
        want = params_from_jax(jtree, case["tc"])
        for name, w in want.items():
            np.testing.assert_allclose(
                _np(tree[name]), _np(w), rtol=0,
                atol=GRAD_REL * float(np.abs(_np(w)).max()) + 1e-30,
                err_msg=name)


def test_accumulated_gradients_equal_the_full_batch(case):
    """The float32 mean of 2 or 4 microbatches' gradients is the full
    batch's (repro's test_grad_accumulation_matches_full_batch), held
    against repro's full-batch gradients."""
    tparams = case["params"]
    _, topt = _opt()
    norms = {}
    for M in (1, 2, 4):
        _, _, m = TT.make_train_step(
            case["tc"], topt, TT.TrainConfig(accum=M, device="cpu"))(
            tparams, TO.adamw_init(tparams), *_torch_batch(case))
        norms[M] = float(m["grad_norm"])
        assert abs(float(m["loss"]) - case["loss"]) < 1e-4
    want = float(np.sqrt(sum((_np(g) ** 2).sum()
                             for g in case["grads"].values())))
    for M, n in norms.items():
        np.testing.assert_allclose(n, want, rtol=1e-5, err_msg=str(M))


def test_reference_cannot_take_a_float32_step(monkeypatch):
    """R9: repro's own barrier, on a float32 model, fails in the
    backward pass; the port's rounds the cotangent once and goes on."""
    monkeypatch.undo()
    jc = dataclasses.replace(jax_smoke("phi4_mini_3b"), **F32)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tok = np.zeros((1, 8), np.int32)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.grad(lambda p: JT.loss_fn(p, jc, tok, tok, z_loss=1e-4,
                                      aux_weight=1e-2)[0])(jp)
    x = torch.tensor([1.0, 3.0], requires_grad=True)
    y = TT._Bf16GradBarrier.apply(x) * torch.tensor([1 + 2 ** -12, 1.0])
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.dtype == torch.float32 and g.tolist() == [1.0, 1.0]
