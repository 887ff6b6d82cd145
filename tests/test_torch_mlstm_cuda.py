"""The port's chunkwise mLSTM CUDA kernel against its plain version.

These run only on the card (``cuda`` marker; they skip without a CUDA
device). The file imports no JAX and no ``repro`` module, so it also
runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*_cuda.py``.
The kernel computes the chunkwise form in float32 and the plain version
the sequential recurrence in float32, so they agree to ``repro``'s own
tolerance for the two forms, rtol = atol = 2e-4
(``tests/test_kernels.py``), and to 1e-5 of the largest |h|: a typical
|h| is ~5e-3 at this draw, so 2e-4 alone would pass products in TF32 or
bf16, which the kernel must not use. Two launches agree bit for bit.
"""
import math

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mlstm import kernel, ops, ref
from repro_torch.models.model import Model

TOL = 2e-4
REL = 1e-5      # of max |h|
MAIN = dict(BH=16, S=2048, hd=256, dtype="bfloat16", gates="paper")
CASES = [
    MAIN,                                   # xlstm-350m's prefill, B=4, H=4
    {**MAIN, "dtype": "float32"},
    {**MAIN, "S": 64},                      # one chunk
    {**MAIN, "BH": 1},
    {**MAIN, "hd": 64},
    {**MAIN, "BH": 4, "S": 256, "hd": 32},   # the xlstm smoke config's heads
    {**MAIN, "S": 2000},                    # not a multiple of the chunk
    {**MAIN, "S": 512, "gates": "extreme"},  # log_f ~ -30, log_i up to +10
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def inputs(case, device, seed=0):
    """q, k ~ N(0, 1/hd), v ~ N(0, 1) in the case's dtype; ``paper``
    gates as ``tests/test_kernels.py`` draws them (log_i <= 0, log_f =
    log sigmoid(N(2, 1))), ``extreme`` ones log_f in [-31, -29] and log_i
    in [-10, 10]."""
    g = torch.Generator(device=device).manual_seed(seed)
    BH, S, hd = case["BH"], case["S"], case["hd"]
    dt = getattr(torch, case["dtype"])
    n = lambda *s: torch.randn(*s, generator=g, device=device)
    q = (n(BH, S, hd) / math.sqrt(hd)).to(dt)
    k = (n(BH, S, hd) / math.sqrt(hd)).to(dt)
    v = n(BH, S, hd).to(dt)
    if case["gates"] == "extreme":
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(
            BH, S, generator=g, device=device)
        log_i, log_f = u(-10.0, 10.0), u(-31.0, -29.0)
    else:
        log_i = -torch.nn.functional.softplus(-n(BH, S))
        log_f = -torch.nn.functional.softplus(-n(BH, S) - 2.0)
    return q, k, v, log_i, log_f


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c.values())) for c in CASES])
def test_cuda_kernel_matches_plain(cuda, case):
    args = inputs(case, cuda, seed=case["S"] + case["hd"])
    before = ops.mlstm.launches
    chunk = 256 if case["S"] % 256 == 0 else case["S"]
    got = ops.mlstm(*args, chunk=chunk)
    want = ref.mlstm_ref(*args)
    torch.cuda.synchronize()
    assert ops.mlstm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert float((got - want).abs().max()) <= REL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 256])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 129, 320])
def test_cuda_kernel_at_the_chunk_edges(cuda, S, hd, dtype):
    """The kernel's chunks are 64 steps: one chunk, a ragged one, and
    every pass (the chunk states, the combine over 1 to 5 chunks, the
    outputs) at each head dim and input dtype, against the recurrence
    and against the plain two-pass form at the kernel's chunk."""
    case = {**MAIN, "BH": 3, "S": S, "hd": hd, "dtype": dtype}
    args = inputs(case, cuda, seed=S * hd)
    got = kernel.mlstm_chunkwise(*args)
    want = ref.mlstm_ref(*args)
    two_pass, _ = ref.mlstm_two_pass_ref(*args, chunk=64)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    peak = float(want.abs().max())
    for other in (want, two_pass):
        torch.testing.assert_close(got, other, rtol=TOL, atol=TOL)
        assert float((got - other).abs().max()) <= REL * peak


@pytest.mark.cuda
def test_cuda_kernel_is_bitwise_repeatable(cuda):
    args = inputs({**MAIN, "S": 1000}, cuda, seed=1)
    a = kernel.mlstm_chunkwise(*args)
    b = kernel.mlstm_chunkwise(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, li, lf = inputs({**MAIN, "S": 128, "hd": 64}, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.mlstm(q.double(), k.double(), v.double(), li, lf)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.mlstm(q.half(), k.half(), v.half(), li, lf)
    with pytest.raises(TypeError, match="k is"):
        ops.mlstm(q, k.float(), v, li, lf)
    with pytest.raises(TypeError, match="log_i must be float32"):
        ops.mlstm(q, k, v, li.double(), lf)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mlstm(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
                  li.T, lf.T)
    with pytest.raises(ValueError, match="head dim"):
        ops.mlstm(q[..., :48].contiguous(), k[..., :48].contiguous(),
                  v[..., :48].contiguous(), li, lf)
    with pytest.raises(ValueError, match="BH, S"):
        ops.mlstm(q, k, v, li[:, :64].contiguous(), lf)
    with pytest.raises(ValueError, match="device"):
        ops.mlstm(q, k, v, li.cpu(), lf)
    with pytest.raises(ValueError, match="divide"):
        ops.mlstm(q[:, :100].contiguous(), k[:, :100].contiguous(),
                  v[:, :100].contiguous(), li[:, :100].contiguous(),
                  lf[:, :100].contiguous(), chunk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_xlstm_smoke_model_prefills_on_the_card(cuda, dtype, rel):
    """``Model(get_smoke_config("xlstm_350m"))`` (head dim 32) prefills on
    the card through the kernel, and matches the same model's forward on
    the CPU (the plain recurrence) with the same params, as
    max|card - cpu| / max|cpu| of the last logits: float32 within 1e-4
    (the kernel's chunkwise sums against the sequential order, through
    two layers), bf16 within 5e-2 (the two devices round bf16
    activations after products summed in different orders)."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("xlstm_350m"), dtype=dtype,
                              param_dtype=dtype)
    assert cfg.head_dim == 32
    model = Model(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(0))
    assert model.device.type == "cuda"
    host = Model(cfg, device="cpu")
    host.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    before = ops.mlstm.launches
    with torch.no_grad():       # a serving prefill: no graph
        got, _ = model(tokens.to(cuda), mode="last_logits")
        torch.cuda.synchronize()
        want, _ = host(tokens, mode="last_logits")
    mlstm_layers = sum(b.kind == "mlstm" for b in model.layers)
    assert ops.mlstm.launches == before + mlstm_layers > before
    assert bool(torch.isfinite(got).all())
    got, want = got.float().cpu(), want.float()
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())
