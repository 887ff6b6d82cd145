"""The port's segment kernels (``repro_torch/kernels/segment_sum``).

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX functions (the Pallas kernels in interpret mode, and
XLA) on int32 and float32, and against a numpy loop on int64/float64
(which JAX rejects with x64 off). Tolerances: integers, counts and
MIN/MAX are exact; a float32 SUM compares at rtol 1e-5 (plus atol 1e-5
for sums near zero), because the two sides add in different orders.

The CUDA kernels themselves run only on the card: their parity tests
are in ``test_torch_segment_sum_cuda.py``, which needs no JAX.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_sum import ops as jops  # noqa: E402
from repro.kernels.segment_sum.ref import (  # noqa: E402
    reduce_identity as jax_reduce_identity)
from repro_torch.kernels import device  # noqa: E402
from repro_torch.kernels.segment_sum import kernel, ops, ref  # noqa: E402

SHAPES = [
    (1000, 37),      # ragged on both axes of the Pallas tiling
    (1024, 512),     # exact block multiples
    (5, 3),          # smaller than any block
    (2000, 1),       # a single segment
]


def _case(n, num_segments, dtype, seed, *, p_valid=0.7, p_nan=0.0,
          used=None):
    """Inputs made from a numpy seed; ``used`` < num_segments leaves the
    segments past it empty."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, used or num_segments, n).astype(np.int32)
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


def _port(fn, vals, ids, valid, *args, **kw):
    out, counts = fn(torch.from_numpy(vals), torch.from_numpy(ids),
                     torch.from_numpy(valid), *args, **kw)
    return out.numpy(), counts.numpy()


def _jax(fn, vals, ids, valid, *args, use_pallas, **kw):
    out, counts = fn(jnp.asarray(vals), jnp.asarray(ids),
                     jnp.asarray(valid), *args, use_pallas=use_pallas,
                     block_n=256, block_s=64, interpret=True, **kw)
    return np.asarray(out), np.asarray(counts)


def _numpy_loop(vals, ids, valid, num_segments, op):
    """Row-order accumulation, as the reference backend does."""
    if op == "sum":
        out = np.zeros(num_segments, vals.dtype)
    else:
        out = np.full(num_segments, ref.reduce_identity(vals.dtype, op))
    counts = np.zeros(num_segments, np.int32)
    seen = np.zeros(num_segments, bool)
    with np.errstate(over="ignore"):        # integer sums wrap
        _accumulate(out, counts, seen, vals, ids, valid, num_segments, op)
    return out, counts


def _accumulate(out, counts, seen, vals, ids, valid, num_segments, op):
    for v, i, ok in zip(vals, ids, valid):
        if not ok or not 0 <= i < num_segments:
            continue
        counts[i] += 1
        if op == "sum":
            out[i] = out[i] + v
        elif not seen[i]:
            out[i] = v
        else:
            out[i] = (np.minimum if op == "min" else np.maximum)(out[i], v)
        seen[i] = True


# ---------------------------------------------------------------------------
# plain versions against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,num_segments", SHAPES)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_sum_matches_jax(n, num_segments, use_pallas, dtype):
    vals, ids, valid = _case(n, num_segments, dtype, seed=n)
    want, want_n = _jax(jops.masked_segment_sum, vals, ids, valid,
                        num_segments, use_pallas=use_pallas)
    got, got_n = _port(ops.masked_segment_sum, vals, ids, valid,
                       num_segments)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got_n, want_n)
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,num_segments", SHAPES)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["min", "max"])
def test_reduce_matches_jax(n, num_segments, use_pallas, dtype, op):
    vals, ids, valid = _case(n, num_segments, dtype, seed=n + 1,
                             p_nan=0.02 if dtype == np.float32 else 0.0)
    want, want_n = _jax(jops.masked_segment_reduce, vals, ids, valid,
                        num_segments, use_pallas=use_pallas, op=op)
    got, got_n = _port(ops.masked_segment_reduce, vals, ids, valid,
                       num_segments, op=op)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_all_invalid_and_empty_segments_match_jax(use_pallas, op):
    """All-invalid rows, plus segments no row names: SUM gives 0 and
    MIN/MAX the identity, with count 0 — on both sides."""
    vals, ids, _ = _case(700, 40, np.float32, seed=7, used=25)
    for valid in (np.zeros(700, bool), np.ones(700, bool)):
        if op == "sum":
            want, want_n = _jax(jops.masked_segment_sum, vals, ids, valid,
                                40, use_pallas=use_pallas)
            got, got_n = _port(ops.masked_segment_sum, vals, ids, valid, 40)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            want, want_n = _jax(jops.masked_segment_reduce, vals, ids,
                                valid, 40, use_pallas=use_pallas, op=op)
            got, got_n = _port(ops.masked_segment_reduce, vals, ids, valid,
                               40, op=op)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_n, want_n)
        assert (got_n[25:] == 0).all()


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int8, np.uint8,
                                   np.int16])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_wide_and_narrow_dtypes_match_numpy_loop(dtype, op):
    """Dtypes JAX rejects (64-bit with x64 off) or never sees here: the
    plain versions against the row-order numpy loop. Integer sums wrap
    in the value dtype, like numpy's; float64 sums at rtol 1e-12."""
    vals, ids, valid = _case(1500, 29, dtype, seed=11,
                             p_nan=0.02 if dtype == np.float64 else 0.0)
    if np.issubdtype(dtype, np.integer):     # push sums past the range
        info = np.iinfo(dtype)
        vals = np.random.default_rng(3).integers(
            info.min, info.max, 1500, endpoint=True).astype(dtype)
    ids[::97] = -1                            # out-of-range ids: nothing
    ids[::89] = 29
    want, want_n = _numpy_loop(vals, ids, valid, 29, op)
    if op == "sum":
        got, got_n = _port(ops.masked_segment_sum, vals, ids, valid, 29)
    else:
        got, got_n = _port(ops.masked_segment_reduce, vals, ids, valid, 29,
                           op=op)
    np.testing.assert_array_equal(got_n, want_n)
    if op == "sum" and dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", ["min", "max"])
def test_tied_signed_zeros_take_the_later_row(dtype, op):
    """Of tied values the later row wins, as np.minimum(acc, v) row by
    row gives: the sign of a tied zero is the last valid row's."""
    r = np.random.default_rng(5)
    vals = np.where(r.random(300) < 0.5, -0.0, 0.0).astype(dtype)
    ids = r.integers(0, 6, 300).astype(np.int32)
    valid = r.random(300) < 0.8
    want, _ = _numpy_loop(vals, ids, valid, 6, op)
    got, _ = _port(ops.masked_segment_reduce, vals, ids, valid, 6, op=op)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    last = [vals[np.flatnonzero((ids == s) & valid)[-1]] for s in range(6)]
    np.testing.assert_array_equal(np.signbit(got), np.signbit(last))


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64,
                                   np.float32, np.float64])
@pytest.mark.parametrize("op", ["min", "max"])
def test_reduce_identity_matches_jax(dtype, op):
    assert ref.reduce_identity(dtype, op) == jax_reduce_identity(dtype, op)
    assert ref.reduce_identity(dtype, op).dtype == np.dtype(dtype)


def test_cpu_calls_do_not_count_launches():
    before = (ops.masked_segment_sum.launches,
              ops.masked_segment_reduce.launches)
    vals, ids, valid = _case(100, 4, np.float32, seed=0)
    _port(ops.masked_segment_sum, vals, ids, valid, 4)
    _port(ops.masked_segment_reduce, vals, ids, valid, 4, op="max")
    assert (ops.masked_segment_sum.launches,
            ops.masked_segment_reduce.launches) == before


def test_wrappers_validate_inputs():
    vals, ids, valid = (torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                        torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        ops.masked_segment_sum(vals, ids.long(), valid, 2)
    with pytest.raises(ValueError):
        ops.masked_segment_sum(vals, ids[:3], valid, 2)
    with pytest.raises(ValueError):
        ops.masked_segment_reduce(vals, ids, valid, 2, op="median")


@pytest.mark.parametrize("launch", [
    lambda v, i, m: kernel.segment_sum(v, i, m, 2),
    lambda v, i, m: kernel.segment_reduce(v, i, m, 2, "min"),
])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    """The CUDA wrappers launch on the card or raise: a CPU tensor never
    reaches a plain version through them (nothing is built to find
    that out)."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
               torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("dtype,lowers", [
    (np.int8, True), (np.int16, True), (np.int32, True), (np.int64, True),
    (np.uint8, True), (np.float32, True), (np.float64, True),
    (np.uint16, False), (np.uint32, False), (np.uint64, False),
    (np.float16, False), (np.bool_, False), (object, False),
    ("datetime64[ns]", False), ("U3", False),
])
def test_device_dtypes(dtype, lowers):
    assert device.device_supports_dtype(dtype) is lowers
