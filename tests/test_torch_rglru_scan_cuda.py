"""The port's RG-LRU scan CUDA kernel against its plain version.

These run only on the card (``cuda`` marker; they skip without a CUDA
device). The file imports no JAX and no ``repro`` module, so it also
runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*_cuda.py``.
The kernel rounds each product and each sum on its own, in the plain
version's order, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _ab(B, S, W, device, seed=0):
    r = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-r.standard_normal((B, S, W))))
    b = r.standard_normal((B, S, W))
    return (torch.from_numpy(a.astype(np.float32)).to(device),
            torch.from_numpy(b.astype(np.float32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("B,S,W", [(1, 128, 128), (2, 256, 256),
                                   (3, 17, 200), (1, 1, 5), (4, 300, 129)])
def test_cuda_kernel_matches_plain(cuda, with_h0, B, S, W):
    a, b = _ab(B, S, W, cuda, seed=S + W)
    h0 = torch.randn(B, W, device=cuda) if with_h0 else None
    before = ops.rglru_scan.launches
    got = ops.rglru_scan(a, b, h0)
    want = ref.rglru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    a, b = _ab(2, 8, 16, cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a.transpose(0, 1), b.transpose(0, 1))
    with pytest.raises(ValueError, match="device"):
        ops.rglru_scan(a, b.cpu())
