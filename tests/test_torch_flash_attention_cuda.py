"""The port's flash attention CUDA kernel against its plain version.

These run only on the card (``cuda`` marker; they skip without a CUDA
device). The file imports no JAX and no ``repro`` module, so it also
runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*_cuda.py``.

Tolerances, as (rtol, atol): both sides compute in float32; they sum
the products and the softmax in different orders, so float32 agrees to
2e-5. bfloat16 inputs are the same numbers for both, and only the
output's rounding to bfloat16 differs: the two float32 results may
straddle a rounding boundary, so they may land one bfloat16 step apart,
at most 2^-7 of the value; the atol covers the float32 order on outputs
near zero.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops, ref

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2 ** -7, 1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, H, K, sq, skv, hd, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    make = lambda *s: torch.from_numpy(
        r.standard_normal(s).astype(np.float32)).to(device, dtype)
    return make(B, H, sq, hd), make(B, K, skv, hd), make(B, K, skv, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)],
                         ids=["causal", "window48", "full"])
@pytest.mark.parametrize("B,H,K,S", [(2, 4, 1, 200), (1, 4, 2, 128)],
                         ids=["mqa-ragged", "gqa2"])
def test_cuda_kernel_matches_plain(cuda, dtype, hd, causal, window, B, H,
                                   K, S):
    q, k, v = _qkv(B, H, K, S, S, hd, dtype, cuda, seed=hd + S)
    name = kernel.kernel_for(dtype, hd)
    before = ops.flash_attention.launches
    by_kernel = ops.flash_attention.launches_by_kernel[name]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert ops.flash_attention.launches_by_kernel[name] == by_kernel + 1
    assert name == ("wgmma" if dtype == torch.bfloat16 and hd >= 64
                    else "simt")
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(96, 160), (64, 512), (1, 70)])
def test_cuda_kernel_uneven_lengths(cuda, sq, skv):
    """Sq != Skv, causal (queries at positions 0..Sq-1), as the JAX
    kernel's tests run it."""
    q, k, v = _qkv(1, 2, 2, sq, skv, 64, torch.float32, cuda, seed=sq)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_kernel_window_wider_than_sequence_and_empty(cuda):
    q, k, v = _qkv(1, 2, 1, 100, 100, 32, torch.float32, cuda)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True, window=1000),
        ref.flash_attention_ref(q, k, v, causal=True), rtol=2e-5,
        atol=2e-5)
    one = ops.flash_attention(q, k, v, causal=True, window=1)
    torch.testing.assert_close(one, v.expand(1, 2, 100, 32), rtol=2e-5,
                               atol=2e-5)   # each query sees itself only
    e = torch.zeros(1, 2, 0, 32, device=cuda)
    assert ops.flash_attention(e, e[:, :1], e[:, :1]).shape == e.shape


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 2048),
                                           (True, 300), (False, None)],
                         ids=["causal", "window2048", "window300", "full"])
@pytest.mark.parametrize("B,H,K,S", [(1, 4, 1, 4096), (2, 4, 1, 1000),
                                     (1, 8, 2, 1536)],
                         ids=["mqa-4096", "mqa-ragged", "gqa4"])
def test_wgmma_kernel_at_long_sequences(cuda, hd, causal, window, B, H, K,
                                        S):
    """The bf16 wgmma kernel over many kv tiles and both pipeline
    stages, within the one-rounding tolerance."""
    q, k, v = _qkv(B, H, K, S, S, hd, torch.bfloat16, cuda, seed=hd + S)
    by_kernel = ops.flash_attention.launches_by_kernel["wgmma"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert ops.flash_attention.launches_by_kernel["wgmma"] == by_kernel + 1
    rtol, atol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# every shape at which the model families that reached the card last
# call flash in chip_smoke.py's phase 10 (its family_flash_cases):
# granite's and llama4's prefills (GQA 24/8 at hd 64, 40/8 at hd 128),
# whisper's encoder, decoder and cross attention (448 positions over 1500
# frames), phi3-vision's hd 96, phi4-mini's bf16 prefill and its
# float32 1024- and 1088-token prefills (simt); then hd 96 in float32
# and a ragged Skv in float32
NEW_SHAPES = {   # id: (B, H, K, Sq, Skv, hd, causal, dtype)
    "granite": (4, 24, 8, 4096, 4096, 64, True, torch.bfloat16),
    "llama4": (2, 40, 8, 4096, 4096, 128, True, torch.bfloat16),
    "encoder": (4, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    "whisper-self": (4, 16, 16, 448, 448, 64, True, torch.bfloat16),
    "cross": (4, 16, 16, 448, 1500, 64, False, torch.bfloat16),
    "hd96-bf16": (4, 32, 32, 4096, 4096, 96, True, torch.bfloat16),
    "phi4": (4, 24, 8, 4096, 4096, 128, True, torch.bfloat16),
    "phi4-f32-1024": (1, 24, 8, 1024, 1024, 128, True, torch.float32),
    "phi4-f32-1088": (1, 24, 8, 1088, 1088, 128, True, torch.float32),
    "hd96-f32": (4, 32, 32, 4096, 4096, 96, True, torch.float32),
    "cross-ragged-f32": (4, 16, 16, 448, 1499, 64, False, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,sq,skv,hd,causal,dtype",
                         list(NEW_SHAPES.values()), ids=list(NEW_SHAPES))
def test_cuda_kernel_at_the_new_families_shapes(cuda, B, H, K, sq, skv, hd,
                                                causal, dtype):
    q, k, v = _qkv(B, H, K, sq, skv, hd, dtype, cuda, seed=sq + skv + hd)
    name = kernel.kernel_for(dtype, hd)
    assert name == ("wgmma" if dtype == torch.bfloat16 else "simt")
    by_kernel = ops.flash_attention.launches_by_kernel[name]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches_by_kernel[name] == by_kernel + 1
    # float32 over up to 4096 keys: chip_smoke.py's FLASH_TOL
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [256, 96])
def test_wgmma_kernel_is_bitwise_repeatable(cuda, hd):
    q, k, v = _qkv(2, 4, 1, 700, 700, hd, torch.bfloat16, cuda, seed=9)
    a = ops.flash_attention(q, k, v, causal=True, window=512)
    b = ops.flash_attention(q, k, v, causal=True, window=512)
    assert torch.equal(a, b)


# hd 96 on the wgmma kernel: TMA boxes of 32 columns under the 64-byte
# swizzle, three a tile, and P V as one m64n96k16 across them
HD96 = {   # id: (B, H, K, Sq, Skv, causal, window)
    "gqa-32/8": (2, 32, 8, 1024, 1024, True, None),
    "window": (2, 8, 8, 1536, 1536, True, 300),
    "cross-sq<skv": (2, 16, 16, 448, 1500, False, None),
    "ragged-skv-1499": (1, 8, 2, 300, 1499, False, None),
    "sq-1": (2, 8, 4, 1, 1499, False, None),
    "sq-1-causal": (2, 8, 4, 1, 70, True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,K,sq,skv,causal,window", list(HD96.values()),
                         ids=list(HD96))
def test_wgmma_kernel_at_hd_96(cuda, B, H, K, sq, skv, causal, window):
    q, k, v = _qkv(B, H, K, sq, skv, 96, torch.bfloat16, cuda,
                   seed=sq + skv)
    assert kernel.kernel_for(torch.bfloat16, 96) == "wgmma"
    by_kernel = ops.flash_attention.launches_by_kernel["wgmma"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches_by_kernel["wgmma"] == by_kernel + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    rtol, atol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_dispatch_table_raises_outside_both_kernels():
    """kernel_for names the kernel of each (dtype, head dim) in the
    table and raises for any other; it needs no card."""
    assert kernel.kernel_for(torch.bfloat16, 256) == "wgmma"
    assert kernel.kernel_for(torch.bfloat16, 32) == "simt"
    assert kernel.kernel_for(torch.bfloat16, 96) == "wgmma"
    assert kernel.kernel_for(torch.float32, 96) == "simt"
    assert kernel.kernel_for(torch.float32, 256) == "simt"
    for dtype, hd in ((torch.bfloat16, 48), (torch.float32, 80),
                      (torch.bfloat16, 512)):
        with pytest.raises(ValueError, match="head dim"):
            kernel.kernel_for(dtype, hd)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.kernel_for(torch.float16, 64)


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(1, 2, 1, 64, 64, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 2, 1, 64, 64, 80, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 2, 1, 64, 64, 32, torch.float16, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 3, 2, 64, 64, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, k.cpu(), v)
