"""``TensorContract.validate_concrete`` in the port against ``repro``'s.

The same numpy-made values go to both: a torch tensor (float32, bf16,
int32) to the port, a jax array of the same dtype (bf16 through
``jnp.bfloat16``) to ``repro``. Each verdict (pass, a shape or dtype
mismatch, a NaN) is the same error class with the same message. The
port reads shape, dtype and NaNs from the tensor where it lies; the
same check on a CUDA tensor is in ``test_torch_schema_cuda.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.core import schema as JS  # noqa: E402
from repro_torch.core import schema as S  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int32": (torch.int32, jnp.int32)}


def _verdict(contract, value):
    try:
        contract.validate_concrete(value, name="x")
    except Exception as e:
        return type(e).__name__, str(e)
    return None


def _value(shape, dtype, nan):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if nan:
        x[0, 0] = np.nan
    t, j = DTYPES[dtype]
    return torch.from_numpy(x).to(t), jnp.asarray(x).astype(j)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,contract_shape,nan,allow_nan", [
    ((3, 4), ("n", 4), False, False),     # passes
    ((3, 5), ("n", 4), False, False),     # shape mismatch
    ((3, 4), (3, 4, 1), False, False),    # rank mismatch
    ((3, 4), ("n", 4), True, False),      # NaN forbidden
    ((3, 4), ("n", 4), True, True),       # NaN allowed
], ids=["pass", "shape", "rank", "nan", "nan-allowed"])
def test_verdicts_match_repro(dtype, shape, contract_shape, nan, allow_nan):
    got_in, want_in = _value(shape, dtype, nan and dtype != "int32")
    contract = dict(shape=contract_shape, dtype=dtype, allow_nan=allow_nan)
    got = _verdict(S.TensorContract(**contract), got_in)
    want = _verdict(JS.TensorContract(**contract), want_in)
    assert got == want
    if nan and not allow_nan and dtype != "int32":
        assert got == ("ContractRuntimeError", "x: contract forbids NaNs")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_mismatch_matches_repro(dtype):
    other = "bfloat16" if dtype == "float32" else "float32"
    got_in, want_in = _value((2, 2), dtype, False)
    got = _verdict(S.TensorContract((2, 2), other), got_in)
    want = _verdict(JS.TensorContract((2, 2), other), want_in)
    assert got == want and got[0] == "ContractRuntimeError"


def test_numpy_arrays_still_validate():
    x = np.zeros((2, 3), np.float32)
    assert _verdict(S.TensorContract(("a", 3), "float32"), x) is None
    x[1, 1] = np.nan
    assert _verdict(S.TensorContract(("a", 3), "float32"), x) == (
        "ContractRuntimeError", "x: contract forbids NaNs")
