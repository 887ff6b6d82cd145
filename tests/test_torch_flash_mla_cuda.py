"""The latent attention flash kernel (``flash_mla_kernel``: bf16, q and
k 192 wide, v 128, the scale passed in) against the plain version.

These run only on the card (``cuda`` marker; they skip without a CUDA
device); the file imports no JAX and no ``repro`` module. Tolerance as
``test_torch_flash_attention_cuda.py``'s bfloat16 one: both sides take
the same bf16 numbers and sum in float32, so only the output's rounding
to bfloat16 differs, at most one bf16 step (2^-7 of the value).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops, ref

SCALE = 0.1147213867929261     # DeepSeek-V2-Lite's YaRN softmax scale


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, H, K, sq, skv, device, seed=0):
    r = np.random.default_rng(seed)
    make = lambda *s: torch.from_numpy(
        r.standard_normal(s).astype(np.float32)).to(device, torch.bfloat16)
    return make(B, H, sq, 192), make(B, K, skv, 192), make(B, K, skv, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)],
                         ids=["causal", "window48", "full"])
@pytest.mark.parametrize("B,H,K,sq,skv", [(2, 4, 4, 200, 200),
                                          (1, 4, 1, 130, 130),
                                          (1, 2, 2, 64, 300),
                                          (1, 16, 16, 1031, 1031)],
                         ids=["ragged", "mqa", "short-q", "ragged-1031"])
@pytest.mark.parametrize("scale", [None, SCALE], ids=["default", "yarn"])
def test_mla_kernel_matches_plain(cuda, causal, window, B, H, K, sq, skv,
                                  scale):
    q, k, v = _qkv(B, H, K, sq, skv, cuda, seed=sq + H)
    assert kernel.kernel_for(q.dtype, 192, 128) == "mla"
    before = ops.flash_attention.launches_by_kernel["mla"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches_by_kernel["mla"] == before + 1
    assert got.shape == (B, H, sq, 128)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.cuda
def test_mla_kernel_refuses_other_head_dims(cuda):
    q, k, v = _qkv(1, 2, 2, 64, 64, cuda)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q[..., :160].contiguous(), k[..., :160]
                            .contiguous(), v)
