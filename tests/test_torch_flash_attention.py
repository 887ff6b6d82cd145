"""The port's flash attention (``repro_torch/kernels/flash_attention``)
against ``repro``'s.

On the CPU the wrapper runs the plain PyTorch version; it is held
against the Pallas kernel in interpret mode
(``repro.kernels.flash_attention.ops.flash_attention``) and against the
model's XLA blockwise path (``repro.models.layers.blockwise_attention``)
on the same numpy inputs. Tolerances: float32 at rtol = atol = 1e-5 (the
three sum in different orders); bfloat16 inputs at 2e-2 (the Pallas
kernel and the plain version compute in float32 and round the output
once; the blockwise path also rounds the probabilities to bfloat16).

The CUDA kernel itself runs only on the card:
``test_torch_flash_attention_cuda.py``, which needs no JAX.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.models.layers import blockwise_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(B, H, K, S, hd, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, S, hd)).astype(np.float32),
            r.standard_normal((B, K, S, hd)).astype(np.float32),
            r.standard_normal((B, K, S, hd)).astype(np.float32))


def _port(arrays, dtype, **kw):
    dt = getattr(torch, dtype)
    out = ops.flash_attention(*(torch.from_numpy(a).to(dt) for a in arrays),
                              **kw)
    assert out.dtype == dt
    return out.float().numpy()


def _jax(fn, arrays, dtype, **kw):
    return np.asarray(fn(*(jnp.asarray(a, dtype) for a in arrays), **kw),
                      np.float32)


CASES = [      # (B, H, K, S, hd, causal, window)
    (2, 4, 4, 64, 32, True, None),        # causal
    (1, 4, 4, 160, 16, True, 32),         # window, S > 2 * window
    (1, 2, 2, 96, 32, False, None),       # non-causal
    (2, 4, 1, 128, 16, True, None),       # MQA (K = 1)
    (1, 4, 2, 128, 32, True, 48),         # GQA (K = 2) with a window
    (1, 2, 1, 200, 16, True, 64),         # S not a multiple of 128
]
IDS = ["causal", "window", "noncausal", "mqa", "gqa2-window", "ragged"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd,causal,window", CASES, ids=IDS)
def test_plain_matches_pallas_kernel(B, H, K, S, hd, causal, window, dtype):
    arrays = _qkv(B, H, K, S, hd, seed=S + hd)
    got = _port(arrays, dtype, causal=causal, window=window)
    want = _jax(jflash, arrays, getattr(jnp, dtype), causal=causal,
                window=window, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd,causal,window", CASES, ids=IDS)
def test_plain_matches_model_blockwise_path(B, H, K, S, hd, causal, window,
                                            dtype):
    arrays = _qkv(B, H, K, S, hd, seed=S + hd + 1)
    got = _port(arrays, dtype, causal=causal, window=window)
    want = _jax(blockwise_attention, arrays, getattr(jnp, dtype),
                causal=causal, window=window, block_q=64, block_kv=64)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("hd", [16, 32, 128, 256, 96])
def test_head_dims(hd):
    arrays = _qkv(1, 2, 1, 40, hd, seed=hd)
    got = _port(arrays, "float32", causal=True, window=16)
    want = _jax(jflash, arrays, jnp.float32, causal=True, window=16,
                interpret=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _qkv2(B, H, K, sq, skv, hd, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, H, sq, hd)).astype(np.float32),
            r.standard_normal((B, K, skv, hd)).astype(np.float32),
            r.standard_normal((B, K, skv, hd)).astype(np.float32))


CROSS = [      # (B, H, K, Sq, Skv, hd): whisper's decoder over its encoder
    (2, 4, 4, 28, 94, 64),        # Sq < Skv, Skv not a multiple of a tile
    (1, 2, 2, 130, 40, 16),       # Sq > Skv
    (1, 4, 2, 16, 75, 96),        # GQA at phi3-vision's head dim
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,sq,skv,hd", CROSS,
                         ids=["sq<skv", "sq>skv", "gqa-hd96"])
def test_plain_matches_at_cross_attention_shapes(B, H, K, sq, skv, hd,
                                                 dtype):
    """Non-causal with Sq != Skv (cross attention, and the encoder's
    bidirectional self attention at Sq = Skv), against the Pallas kernel
    in interpret mode and the model's blockwise path."""
    arrays = _qkv2(B, H, K, sq, skv, hd, seed=sq + skv + hd)
    got = _port(arrays, dtype, causal=False)
    for fn, kw in ((jflash, dict(block_q=32, block_kv=32, interpret=True)),
                   (blockwise_attention, dict(block_q=32, block_kv=32))):
        want = _jax(fn, arrays, getattr(jnp, dtype), causal=False, **kw)
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_at_hd_96_causal(dtype):
    """phi3-vision's prefill: causal, hd 96, S past one 128-query tile."""
    arrays = _qkv(1, 4, 4, 200, 96, seed=96)
    got = _port(arrays, dtype, causal=True)
    want = _jax(jflash, arrays, getattr(jnp, dtype), causal=True,
                block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,window", [(1, 4, 2, 200, 48),
                                            (1, 2, 2, 203, 100),
                                            (1, 4, 1, 130, 64)],
                         ids=["gqa2-window", "ragged-window", "mqa-window"])
def test_plain_matches_at_hd_96_with_a_window(B, H, K, S, window, dtype):
    """hd 96 under a sliding window, over more than one 64-key tile, with
    S (so Skv) not a multiple of 64, and under MQA (K = 1)."""
    arrays = _qkv(B, H, K, S, 96, seed=S + window)
    got = _port(arrays, dtype, causal=True, window=window)
    want = _jax(jflash, arrays, getattr(jnp, dtype), causal=True,
                window=window, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_hd_96_goes_to_wgmma_in_bf16_and_simt_in_float32():
    """The wgmma kernel takes bf16 at hd 96 (TMA boxes of 32 columns);
    float32, which the bf16 tensor cores do not take, stays on the
    float32-FMA kernel."""
    from repro_torch.kernels.flash_attention import kernel
    assert 96 in kernel.HEAD_DIMS
    assert kernel.kernel_for(torch.bfloat16, 96) == "wgmma"
    assert kernel.kernel_for(torch.float32, 96) == "simt"
    assert kernel.kernel_for(torch.bfloat16, 64) == "wgmma"


def test_gqa_reads_kv_head_h_over_group():
    """Query head h reads kv head h // (H / K): the same as repeating
    each kv head H / K times."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 6, 2, 24, 16, seed=3))
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k.repeat_interleave(3, 1),
                                   v.repeat_interleave(3, 1))
    assert torch.equal(got, want)


def test_cpu_calls_do_not_count_and_bad_input_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 16, seed=0))
    before = ops.flash_attention.launches
    ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="4-D"):
        ops.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 16), v)
