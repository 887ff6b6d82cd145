"""Gradients through the port's model kernels on the card.

The CUDA kernels have no backward; each wrapper (``flash_attention``,
``mlstm``, ``rglru_scan``) goes through an ``autograd.Function`` when an
input requires a gradient (``kernels/autograd.py``). These hold each
Function's gradients of ``(out * g).sum()`` against autograd of the plain
version on the same card tensors, and check that a CUDA input requiring
a gradient never gets an output without a ``grad_fn`` (the silent loss
of a gradient). They run only on the card (``cuda`` marker) and import
no JAX: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_autograd_cuda.py``.

Tolerances, as max|function - plain| / max|plain| per gradient: float32
1e-4 (the mLSTM's chunk-parallel recompute against the sequential
recurrence: different summation orders), bfloat16 2e-2 (both sides round
a float32 gradient once to bfloat16, a step of 2^-8 of the value; flash's
backward reads the kernel's bfloat16 output where the plain version's
autograd has its float32 one). The smoke model's step on the card is held
against the same step on the CPU at 1e-3 of each gradient's max (float32
activations; the kernel's chunkwise sums against the CPU's sequential
recurrence, through two layers and back).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mlstm import ops as mops
from repro_torch.kernels.mlstm.ref import mlstm_ref
from repro_torch.kernels.rglru import ops as rops
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.models.model import Model
from repro_torch.training.train_loop import TrainConfig, make_grad_fn

REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STEP_REL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _check(fn, plain, inputs, wrapper, seed=0):
    inputs = [t.detach().requires_grad_(True) for t in inputs]
    before = wrapper.launches
    out = fn(*inputs)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, device=out.device, dtype=out.dtype,
                    generator=torch.Generator(out.device).manual_seed(seed))
    got = torch.autograd.grad((out * g).sum(), inputs)
    assert wrapper.launches == before + 1      # the forward, not the backward
    want = torch.autograd.grad((plain(*inputs) * g).sum(), inputs)
    for x, a, b in zip(inputs, got, want):
        assert a.dtype == b.dtype == x.dtype and a.shape == x.shape
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= REL[x.dtype], (x.dtype, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,hd", [(4, 128, 32), (2, 200, 64),
                                     (2, 64, 256)])
def test_mlstm_gradients(cuda, dtype, BH, S, hd):
    g = torch.Generator(cuda).manual_seed(1)
    n = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q = (n(BH, S, hd) / math.sqrt(hd)).to(dtype)
    k = (n(BH, S, hd) / math.sqrt(hd)).to(dtype)
    v = n(BH, S, hd).to(dtype)
    log_i = -torch.nn.functional.softplus(-n(BH, S))
    log_f = -torch.nn.functional.softplus(-n(BH, S) - 2.0)
    _check(mops.mlstm, mlstm_ref, [q, k, v, log_i, log_f], mops.mlstm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,S,hd,window", [(4, 4, 128, 64, None),
                                             (8, 2, 200, 128, 48),
                                             (4, 1, 96, 256, 32)])
def test_flash_attention_gradients(cuda, dtype, H, K, S, hd, window):
    g = torch.Generator(cuda).manual_seed(2)
    qkv = [torch.randn(2, n, S, hd, generator=g, device=cuda, dtype=dtype)
           for n in (H, K, K)]
    kw = dict(causal=True, window=window)
    _check(lambda q, k, v: fops.flash_attention(q, k, v, **kw),
           lambda q, k, v: flash_attention_ref(q, k, v, **kw), qkv,
           fops.flash_attention)


@pytest.mark.cuda
def test_rglru_scan_gradients(cuda):
    g = torch.Generator(cuda).manual_seed(3)
    a = torch.sigmoid(torch.randn(2, 96, 256, generator=g, device=cuda))
    b = torch.randn(2, 96, 256, generator=g, device=cuda)
    _check(rops.rglru_scan, rglru_scan_ref, [a, b], rops.rglru_scan)


@pytest.mark.cuda
def test_no_output_without_a_grad_fn(cuda):
    """Inputs that require a gradient always give a grad_fn; without
    one, or under no_grad, the call is the bare launch (no graph)."""
    q = torch.randn(4, 64, 32, device=cuda)
    gates = torch.randn(4, 64, device=cuda)
    x = torch.randn(1, 4, 64, 64, device=cuda)
    a = torch.rand(2, 64, 32, device=cuda)
    calls = [(lambda t: mops.mlstm(t, q, q, gates, gates), q),
             (lambda t: mops.mlstm(q, q, q, gates, t), gates),
             (lambda t: fops.flash_attention(t, x, x), x),
             (lambda t: fops.flash_attention(x, x, t), x),
             (lambda t: rops.rglru_scan(t, a), a),
             (lambda t: rops.rglru_scan(a, t), a)]
    for call, t in calls:
        leaf = t.clone().requires_grad_(True)
        assert call(leaf).grad_fn is not None
        assert call(t).grad_fn is None
        with torch.no_grad():
            assert call(leaf).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_smoke_step_on_the_card_matches_the_cpu(cuda, remat):
    """One step's loss and every gradient of the xlstm smoke model (float32
    activations) through the mLSTM kernel on the card, against the same
    step on the CPU; under ``remat`` the backward recomputes each
    super-block, so the kernel launches twice per mLSTM layer."""
    cfg = dataclasses.replace(get_smoke_config("xlstm_350m"),
                              dtype="float32", param_dtype="float32")
    model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    tc = TrainConfig(remat=remat)
    (want, _), want_g = make_grad_fn(cfg, tc)(params, inputs, targets)
    before = mops.mlstm.launches
    (got, _), got_g = make_grad_fn(cfg, tc)(
        {k: v.to(cuda) for k, v in params.items()}, inputs.to(cuda),
        targets.to(cuda))
    layers = sum(k == "mlstm" for k in cfg.block_pattern) * cfg.n_scan_blocks
    assert mops.mlstm.launches - before == layers * (2 if remat else 1)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for name, w in want_g.items():
        assert got_g[name].device.type == "cuda"
        assert _rel(got_g[name].cpu(), w) <= STEP_REL, name
