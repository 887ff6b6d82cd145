"""The port's segment CUDA kernels against their plain versions.

These run only on the card (``cuda`` marker; they skip without a CUDA
device). The file imports no JAX and no ``repro`` module, so it also
runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*_cuda.py``.
Tolerances: counts, integers and MIN/MAX bit for bit; a float SUM
against the CPU's sequential order at rtol 1e-4 (float32) / 1e-12
(float64), atol 1e-3 for sums near zero, and bit for bit across two
launches. At the slice's sizes, a float SUM within ``SUM_RTOL`` of
sum(|v|) per segment (as ``chip_smoke.py`` holds it).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.segment_sum import kernel, ops, ref

N_ROWS = 6_001_215              # lineitem at TPC-H SF1
INT_DTYPES = [torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8]
SUM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


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


def _slice_case(n, num_segments, dtype, device, seed, runs=False):
    """ids over [0, S) with out-of-range ids (-1, S, INT32_MAX), 10%
    invalid lanes, integers over the dtype's whole range (the sums wrap),
    floats ~ N(0, 100). ``runs``: the ids sorted, so a group's rows lie
    together (as Q18's orders do in lineitem)."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, num_segments, (n,), generator=g, device=device,
                        dtype=torch.int32)
    r = torch.rand(n, generator=g, device=device)
    ids[r < 5e-4] = -1
    ids[r > 1 - 5e-4] = num_segments
    ids[(r > 0.5) & (r < 0.5 + 1e-4)] = 2**31 - 1
    if runs:
        ids = torch.sort(ids).values
    valid = torch.rand(n, generator=g, device=device) >= 0.1
    if dtype.is_floating_point:
        v = (torch.randn(n, generator=g, device=device,
                         dtype=torch.float64) * 100).to(dtype)
    else:
        info = torch.iinfo(dtype)
        v = torch.randint(info.min, info.max, (n,), generator=g,
                          device=device, dtype=torch.int64).to(dtype)
    return v, ids, valid


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", INT_DTYPES, ids=str)
@pytest.mark.parametrize("num_segments", [4, 1_500_000])
@pytest.mark.parametrize("runs", [False, True], ids=["scattered", "runs"])
def test_integer_sum_is_exact_at_the_slice_sizes(cuda, dtype, num_segments,
                                                 runs):
    """Integer SUM (integer atomics, any order; a run of equal ids within
    a warp adds up first) and counts bit for bit against the plain
    version, wraparound included."""
    v, ids, valid = _slice_case(N_ROWS, num_segments, dtype, cuda, seed=1,
                                runs=runs)
    before = ops.masked_segment_sum.launches
    got, got_n = ops.masked_segment_sum(v, ids, valid, num_segments)
    want, want_n = ref.masked_segment_sum_ref(v, ids, valid, num_segments)
    assert ops.masked_segment_sum.launches == before + 1
    assert torch.equal(got_n, want_n)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", INT_DTYPES, ids=str)
@pytest.mark.parametrize("num_segments",
                         [5, 16, 17, 300, 4096, 4097, 20000])
def test_integer_sum_paths_agree(cuda, dtype, num_segments):
    """Each atomic shape, reached by S on either side of the source's
    switch points, gives the plain version's bits."""
    v, ids, valid = _slice_case(200_003, num_segments, dtype, cuda, seed=2,
                                runs=num_segments % 2 == 0)
    want = ref.masked_segment_sum_ref(v, ids, valid, num_segments)
    got = kernel.segment_sum_atomic(v, ids, valid, num_segments)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("num_segments", [4, 1_500_000])
def test_float_sum_is_repeatable_and_within_tolerance(cuda, dtype,
                                                      num_segments):
    v, ids, valid = _slice_case(N_ROWS, num_segments, dtype, cuda, seed=3)
    got, got_n = ops.masked_segment_sum(v, ids, valid, num_segments)
    again, _ = ops.masked_segment_sum(v, ids, valid, num_segments)
    want, want_n = ref.masked_segment_sum_ref(v, ids, valid, num_segments)
    mass, _ = ref.masked_segment_sum_ref(v.abs(), ids, valid, num_segments)
    assert torch.equal(got_n, want_n)
    assert torch.equal(_bits(got), _bits(again))
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= SUM_RTOL[dtype] * mass.double()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("num_segments", [4, 1_500_000])
def test_min_max_tie_signs_after_the_partition(cuda, op, num_segments):
    """Every value a signed zero: the later row of a tie wins, so the
    sign of each segment's result is the plain version's, bit for bit."""
    _, ids, valid = _slice_case(N_ROWS, num_segments, torch.int8, cuda,
                                seed=4)
    g = torch.Generator(device=cuda).manual_seed(5)
    v = torch.where(torch.rand(N_ROWS, generator=g, device=cuda) < 0.5,
                    -0.0, 0.0).to(torch.float64)
    got, got_n = ops.masked_segment_reduce(v, ids, valid, num_segments,
                                           op=op)
    want, want_n = ref.masked_segment_reduce_ref(v, ids, valid,
                                                 num_segments, op)
    assert torch.equal(got_n, want_n)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments", [1, 4, 255, 256, 70_000, 1_500_000])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float32,
                                   torch.float64], ids=str)
def test_run_order_is_a_stable_partition(cuda, num_segments, dtype):
    """The radix partition is a stable sort by key (id in [0, S) ? id :
    S), with values and validity carried along."""
    v, ids, valid = _slice_case(300_007, num_segments, dtype, cuda, seed=6)
    got_v, got_i, got_m = kernel.run_order(v, ids, valid, num_segments)
    keys = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    want_i, perm = torch.sort(keys, stable=True)
    assert torch.equal(got_i, want_i)
    assert torch.equal(_bits(got_v), _bits(v[perm]))
    assert torch.equal(got_m, valid[perm])


def _minmax_case(n, num_segments, dtype, device, seed):
    """ids scattered over [0, S), with out-of-range ids and invalid
    lanes; every third segment left empty; floats with +-0.0 tied in
    most segments and a NaN in a few; integers over the dtype's range."""
    v, ids, valid = _slice_case(n, num_segments, dtype, device, seed)
    ids = torch.where((ids >= 0) & (ids < num_segments) & (ids % 3 == 2)
                      & (num_segments > 2), ids - 1, ids)
    if dtype.is_floating_point:
        g = torch.Generator(device=device).manual_seed(seed + 1)
        r = torch.rand(n, generator=g, device=device)
        v[r < 0.3] = 0.0
        v[(r >= 0.3) & (r < 0.6)] = -0.0
        v[r > 1 - 2e-5] = float("nan")
    return v, ids, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.int64,
                                   torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("num_segments",
                         [4, 16, 17, 300, 4096, 4097, 20000])
@pytest.mark.parametrize("op", ["min", "max"])
def test_min_max_atomic_shapes_are_exact(cuda, dtype, num_segments, op):
    """Each atomic MIN/MAX shape (registers to S = 16, shared bins to
    4096, global atomics above), on either side of its switch points:
    values and counts bit for bit against the plain version, signed
    zeros, NaNs, out-of-range ids and empty segments included, and the
    same bits on a second launch. The wrapper runs no partition."""
    v, ids, valid = _minmax_case(200_003, num_segments, dtype, cuda,
                                 seed=num_segments)
    want, want_n = ref.masked_segment_reduce_ref(v, ids, valid,
                                                 num_segments, op)
    got, got_n = kernel.segment_reduce(v, ids, valid, num_segments, op)
    again, _ = ops.masked_segment_reduce(v, ids, valid, num_segments, op=op)
    assert bool((want_n == 0).any())           # empty segments are covered
    assert torch.equal(got_n, want_n)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(got))
