"""The port's RG-LRU scan (``repro_torch/kernels/rglru``) against
``repro``'s.

On the CPU the wrapper runs the plain sequential version; it is held
against the Pallas kernel in interpret mode
(``repro.kernels.rglru.ops.rglru_scan``), the sequential oracle
(``rglru_scan_ref``) and the model's associative scan
(``repro.models.rglru._lru_scan``, which takes ``h0``), on the same
numpy inputs, at rtol = atol = 1e-5: all are float32 and associate the
products in different orders; |a| < 1 keeps the error from growing.

The CUDA kernel itself runs only on the card:
``test_torch_rglru_scan_cuda.py``, which needs no JAX.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ops import rglru_scan as jscan  # noqa: E402
from repro.kernels.rglru.ref import rglru_scan_ref as jref  # noqa: E402
from repro.models.rglru import _lru_scan  # noqa: E402
from repro_torch.kernels.rglru import ops, ref  # noqa: E402

SHAPES = [(1, 128, 128), (2, 256, 64), (3, 50, 20), (1, 1, 8)]


def _ab(B, S, W, seed):
    r = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-r.standard_normal((B, S, W))))).astype(np.float32)
    b = r.standard_normal((B, S, W)).astype(np.float32)
    h0 = r.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


def _port(a, b, h0=None):
    t = torch.from_numpy
    return ops.rglru_scan(t(a), t(b), None if h0 is None else t(h0)).numpy()


@pytest.mark.parametrize("B,S,W", SHAPES)
def test_plain_matches_pallas_kernel_and_oracle(B, S, W):
    a, b, _ = _ab(B, S, W, seed=S + W)
    got = _port(a, b)
    pallas = np.asarray(jscan(jnp.asarray(a), jnp.asarray(b), block_s=64,
                              block_w=128, interpret=True))
    oracle = np.asarray(jref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("B,S,W", SHAPES)
def test_plain_matches_model_associative_scan(B, S, W, with_h0):
    a, b, h0 = _ab(B, S, W, seed=S * W)
    h0 = h0 if with_h0 else None
    got = _port(a, b, h0)
    want = np.asarray(jax.jit(_lru_scan)(
        jnp.asarray(a), jnp.asarray(b),
        None if h0 is None else jnp.asarray(h0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if h0 is not None:
        seq = np.asarray(jref(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(h0)))
        np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)


def test_h0_folds_into_the_first_step_exactly():
    a, b, h0 = (torch.from_numpy(x) for x in _ab(2, 9, 5, seed=1))
    assert torch.equal(ops.rglru_scan(a, b, h0), ref.rglru_scan_ref(a, b, h0))


def test_cpu_calls_do_not_count_and_bad_input_raises():
    a, b, _ = (torch.from_numpy(x) for x in _ab(1, 4, 3, seed=2))
    before = ops.rglru_scan.launches
    ops.rglru_scan(a, b)
    assert ops.rglru_scan.launches == before
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan(a, b[:, :2])
    with pytest.raises(ValueError, match="h0"):
        ops.rglru_scan(a, b, torch.zeros(1, 4))
