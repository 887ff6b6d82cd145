"""The port's segment CUDA kernels against their plain versions.

These run only on the card (``cuda`` marker; they skip without a CUDA
device). The file imports no JAX and no ``repro`` module, so it also
runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*_cuda.py``.
Tolerances: counts, integers and MIN/MAX bit for bit; a float SUM
against the CPU's sequential order at rtol 1e-4 (float32) / 1e-12
(float64), atol 1e-3 for sums near zero, and bit for bit across two
launches.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.segment_sum import ops, ref


def _case(n, num_segments, dtype, seed, *, p_valid=0.7, p_nan=0.0):
    """Inputs made from a numpy seed."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, num_segments, n).astype(np.int32)
    valid = r.random(n) < p_valid
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        vals = r.integers(max(info.min, -50), min(info.max, 50),
                          n).astype(dtype)
    else:
        vals = r.normal(size=n).astype(dtype)
        if p_nan:
            vals[r.random(n) < p_nan] = np.nan
    return vals, ids, valid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.int64,
                                   torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("n,num_segments", [(70_000, 3), (9_000, 2_500),
                                            (5, 3), (0, 4)])
def test_cuda_kernel_matches_plain(cuda, dtype, op, n, num_segments):
    npdt = ref.numpy_dtype(dtype)
    vals, ids, valid = _case(n, num_segments, npdt, seed=n,
                             p_nan=0.01 if op != "sum" and
                             npdt.kind == "f" else 0.0)
    if npdt.kind == "f":
        vals[::7] = -0.0
        vals[::11] = 0.0
    ids[::53] = -1
    v, i, m = (torch.from_numpy(x).to(cuda) for x in (vals, ids, valid))
    if op == "sum":
        got = ops.masked_segment_sum(v, i, m, num_segments)
        again = ops.masked_segment_sum(v, i, m, num_segments)
        want = ref.masked_segment_sum_ref(v.cpu(), i.cpu(), m.cpu(),
                                          num_segments)
    else:
        got = ops.masked_segment_reduce(v, i, m, num_segments, op=op)
        again = ops.masked_segment_reduce(v, i, m, num_segments, op=op)
        want = ref.masked_segment_reduce_ref(v.cpu(), i.cpu(), m.cpu(),
                                             num_segments, op)
    assert torch.equal(got[1].cpu(), want[1])
    # bitwise across launches; float SUM against the CPU's sequential
    # order at rtol 1e-4 (float32) / 1e-12 (float64), atol 1e-3 for sums
    # near zero; everything else bit for bit
    assert got[0].cpu().numpy().tobytes() == again[0].cpu().numpy().tobytes()
    if op == "sum" and npdt.kind == "f":
        np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                                   rtol=1e-4 if npdt == np.float32
                                   else 1e-12, atol=1e-3)
    else:
        assert got[0].cpu().numpy().tobytes() == want[0].numpy().tobytes()
