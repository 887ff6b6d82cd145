"""``TensorContract.validate_concrete`` on a CUDA tensor.

Runs only on the card (``cuda`` marker; it skips without a CUDA
device), and imports no JAX: the verdicts are held against the same
tensor on the CPU, whose verdicts ``test_torch_schema.py`` holds
against ``repro``'s.
"""
import pytest
import torch

from repro_torch.core.schema import TensorContract


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _verdict(contract, value):
    try:
        contract.validate_concrete(value, name="x")
    except Exception as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_tensor_verdicts(cuda, dtype):
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0)).to(dtype)
    name = str(dtype).removeprefix("torch.")
    cases = [TensorContract(("n", 4), name), TensorContract((3, 5), name),
             TensorContract((3, 4), "int32")]
    for contract in cases:
        assert _verdict(contract, x.to(cuda)) == _verdict(contract, x)
    assert _verdict(cases[0], x.to(cuda)) is None
    x[1, 2] = float("nan")
    assert _verdict(cases[0], x.to(cuda)) == (
        "ContractRuntimeError", "x: contract forbids NaNs")
