"""The port's roofline (``repro_torch.roofline``): ``analyze_hlo`` on
``tests/test_roofline.py``'s synthetic HLO, equal to ``repro``'s;
``analyze_step`` on products with known counts; the terms with the
H100's constants."""
import importlib.util
import os

import pytest
import torch

from repro.roofline.analysis import analyze_hlo as repro_analyze_hlo
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (analyze_hlo, analyze_step,
                                           roofline_terms)

_HERE = os.path.dirname(os.path.abspath(__file__))


def _synth() -> str:
    spec = importlib.util.spec_from_file_location(
        "repro_test_roofline", os.path.join(_HERE, "test_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SYNTH


SYNTH = _synth()
VARIANTS = {
    "plain": SYNTH,
    "known_trips": SYNTH.replace(
        "condition=%cond, body=%body",
        'condition=%cond, body=%body, backend_config='
        '{"known_trip_count":{"n":"7"}}'),
    "comment_types": SYNTH.replace("(s32[], f32[8,8]) while",
                                   "(s32[], /*index=1*/f32[8,8]) while"),
}


def test_synthetic_while_flops_multiplied():
    hc = analyze_hlo(SYNTH)
    assert hc.flops == pytest.approx(2 * 8 * 8 * 8 * 10)
    assert hc.dot_count == 1
    assert hc.while_trips == {"w": 10}


def test_synthetic_collectives_multiplied():
    hc = analyze_hlo(SYNTH)
    assert hc.collective_bytes == pytest.approx(8 * 8 * 4 * 10)
    assert hc.collective_ops == {"all-reduce": pytest.approx(2560.0)}


def test_known_trip_count_backend_config_preferred():
    hc = analyze_hlo(VARIANTS["known_trips"])
    assert hc.while_trips == {"w": 7}
    assert hc.flops == pytest.approx(2 * 8 * 8 * 8 * 7)


def test_comment_stripping_tuple_types():
    assert analyze_hlo(VARIANTS["comment_types"]).while_trips == {"w": 10}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_analyze_hlo_equals_repro(name):
    got, want = analyze_hlo(VARIANTS[name]), repro_analyze_hlo(VARIANTS[name])
    for field in ("flops", "collective_bytes", "collective_ops", "dot_count",
                  "while_trips", "unparsed_dots"):
        assert getattr(got, field) == getattr(want, field), field
    # the HBM proxy differs only by the on-chip threshold (L2, not VMEM):
    # none of these tensors is near either
    assert got.hbm_bytes == want.hbm_bytes


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_analyze_step_matmul(device):
    M, K, N = 64, 128, 32
    a = torch.zeros(M, K, device=device)
    b = torch.zeros(K, N, device=device)
    cost = analyze_step(lambda x, y: x @ y, a, b)
    assert cost.flops == 2 * M * K * N
    assert cost.collective_bytes == 0 and cost.saved_bytes == 0


@pytest.mark.parametrize("L", [1, 5, 9])
def test_analyze_step_python_loop_of_matmuls(L):
    D = 32
    x = torch.zeros(4, D, device="meta")
    ws = [torch.zeros(D, D, device="meta") for _ in range(L)]

    def f(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)      # elementwise work is not counted
        return x

    assert analyze_step(f, x, ws).flops == 2 * 4 * D * D * L


def test_analyze_step_counts_kernels_and_saved_bytes():
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         live_pairs)
    from repro_torch.kernels.flash_attention.ref import band_mask
    B, H, S, hd = 2, 3, 64, 16
    q = torch.zeros(B, H, S, hd, device="meta", requires_grad=True)
    k = torch.zeros(B, 1, S, hd, device="meta", requires_grad=True)
    for causal, window in ((True, None), (True, 16), (False, None),
                           (False, 8)):
        assert live_pairs(S, S, causal, window) == int(
            band_mask(S, S, causal=causal, window=window).sum())
    w = torch.zeros(hd, hd, device="meta", requires_grad=True)

    def step(q, k, w):
        out = flash_attention(q @ w, k, k, causal=True)
        out.sum().backward()
        return out

    cost = analyze_step(step, q, k, w)
    pairs = live_pairs(S, S, True, None)
    assert cost.kernel_flops["flash_attention"] == 4 * hd * pairs * B * H
    assert cost.kernel_flops["flash_attention.backward"] == \
        10 * hd * S * S * B * H
    # the product q @ w (forward) and its two gradient products
    assert cost.flops == 3 * 2 * B * H * S * hd * hd + sum(
        cost.kernel_flops.values())
    assert cost.saved_bytes > 0


def test_h100_constants():
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.PEAK_FLOPS_FP32 == 67e12
    assert hw.HBM_BW == 3.35e12 and hw.NVLINK_BW == 900e9
    assert hw.HBM_BYTES == 80 * 10**9


def test_roofline_term_arithmetic():
    r = roofline_terms(arch="a", shape="s", mesh="single", chips=256,
                       hlo_flops=256 * hw.PEAK_FLOPS_BF16,
                       model_flops=128 * hw.PEAK_FLOPS_BF16,
                       hbm_bytes=256 * hw.HBM_BW * 0.5,
                       collective_bytes=256 * hw.NVLINK_BW * 0.25)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.useful_ratio == pytest.approx(0.5)


def test_roofline_bottleneck_selection():
    r = roofline_terms(arch="a", shape="s", mesh="m", chips=1,
                       hlo_flops=0.0, model_flops=0.0,
                       hbm_bytes=hw.HBM_BW * 2,
                       collective_bytes=hw.NVLINK_BW)
    assert r.bottleneck == "memory"
