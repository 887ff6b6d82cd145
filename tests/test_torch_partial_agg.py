"""The port's partial group-by (``PartitionedBackend._partial_group_by``)
against ``repro``'s host backends.

``PartitionedBackend(device="cpu", devices=["cpu"] * k)`` runs the
multi-card code in one process: ``k`` source partitions (contiguous
row ranges) each reduce their rows into every slot through the segment
wrappers (their plain versions on the CPU), and ``k`` owners combine
their slot range of every source's partials in source order. One card
(``k = 1``) has no combine. The results are held against ``repro``'s
``reference`` oracle and ``vectorized`` backend on the same column
dicts: integers, counts, MIN/MAX, validity and the output order bit for
bit (by ``repr``, so NaN, ``-0.0`` and the dtype show); float SUM/MEAN
within the carve-out's absolute tolerance, and bitwise the same on a
rerun.

``repro``'s ``sharded`` backend is not the yardstick: it needs
``jax.experimental.enable_x64``, which this JAX no longer has.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.exec.reference import ReferenceBackend  # noqa: E402
from repro.exec.vectorized import VectorizedBackend  # noqa: E402

from repro_torch.data import bfloat16  # noqa: E402
from repro_torch.exec import partitioned as part  # noqa: E402
from repro_torch.exec.base import AGG_FNS  # noqa: E402
from repro_torch.exec.partitioned import PartitionedBackend  # noqa: E402
from repro_torch.exec.torch_backend import TorchBackend  # noqa: E402
from repro_torch.obs import tracing  # noqa: E402

REF = ReferenceBackend()
VEC = VectorizedBackend()
INHERITED = TorchBackend(device="cpu")
CARDS = (1, 2, 3, 8)
# float SUM/MEAN: the one tolerance, absolute (near-zero sums of N(0,1)
# values drift absolutely under regrouping): float64 at
# test_group_by_agg.py's 1e-9; float32 sums of up to ~100 such values
# regroup by a few float32 steps (2^-23 ~ 1.2e-7 of the partial sums)
ATOL = {np.dtype(np.float64): 1e-9, np.dtype(np.float32): 1e-5}


def carveout(*cols, dtype=np.float64) -> dict:
    """{output column: its absolute tolerance} for SUM/MEAN outputs of
    value columns of ``dtype``."""
    return {c: ATOL[np.dtype(dtype)] for c in cols}


def backend(k: int) -> PartitionedBackend:
    return PartitionedBackend(device="cpu", devices=["cpu"] * k)


def specs_for(values, fns=AGG_FNS):
    return tuple((fn, v, f"{v}_{fn}") for v in values for fn in fns)


def assert_agg_equal(got, want, floats=None):
    floats = floats or {}
    assert list(got) == list(want)
    for c in want:
        (gv, gm), (wv, wm) = got[c], want[c]
        n = len(wv)
        assert len(gv) == n and gv.dtype == wv.dtype, c
        gm = np.ones(n, bool) if gm is None else gm
        wm = np.ones(n, bool) if wm is None else wm
        assert np.array_equal(gm, wm), c
        if c in floats:
            np.testing.assert_allclose(gv[wm], wv[wm], rtol=0,
                                       atol=floats[c], err_msg=c)
        else:
            assert [repr(x) for x in gv] == [repr(x) for x in wv], c


def partial_spans(rec):
    return [s for s in rec.spans("kernel")
            if s.attrs.get("op") == "partitioned.partial_agg"]


def run(k, cols, keys, specs):
    """The backend's result, and whether the partial path took it."""
    with tracing() as rec:
        got = backend(k).group_by_agg(cols, keys, specs)
    return got, len(partial_spans(rec)) == 1


def masked(values, valid):
    return (np.asarray(values), np.asarray(valid, dtype=bool))


def adversarial(n: int, seed: int) -> dict:
    """Negative int keys, NULL keys and values, NaN float values, an
    all-NULL-valued group (key 5 in v32), int64 and float32 values."""
    r = np.random.default_rng(seed)
    ki = r.integers(-3, 6, n).astype(np.int64)
    f = r.normal(size=n)
    f[r.random(n) < 0.1] = np.nan
    v32 = r.integers(-1000, 1000, n).astype(np.int32)
    v32_ok = r.random(n) > 0.2
    v32_ok[ki == 5] = False
    return {"ki": masked(ki, r.random(n) > 0.1),
            "v32": masked(v32, v32_ok),
            "f": (f, None),
            "i64": masked(r.integers(-2**40, 2**40, n), r.random(n) > 0.3),
            "f32": masked(r.normal(size=n).astype(np.float32),
                          r.random(n) > 0.1)}


FLOATS = {**carveout("f_sum", "f_mean"),
          **carveout("f32_sum", "f32_mean", dtype=np.float32)}


# ---------------------------------------------------------------------------
# every fn against reference and vectorized
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", CARDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_fn_matches_reference(k, seed):
    cols = adversarial(300, seed)
    specs = specs_for(("v32", "f", "i64", "f32"))
    got, took = run(k, cols, ["ki"], specs)
    assert took
    for yardstick in (REF, VEC):
        assert_agg_equal(got, yardstick.group_by_agg(cols, ["ki"], specs),
                         FLOATS)


@pytest.mark.parametrize("k", CARDS)
@pytest.mark.parametrize("n", [0, 1, 2, 7])
def test_empty_and_tiny_tables(k, n):
    """No rows (the inherited path), and fewer rows than partitions
    (empty source partitions are left out of the combine)."""
    cols = adversarial(n, 3)
    specs = specs_for(("v32", "f"))
    got, took = run(k, cols, ["ki"], specs)
    assert took == (n > 0)
    assert_agg_equal(got, REF.group_by_agg(cols, ["ki"], specs), FLOATS)


def test_all_null_keys_form_one_group():
    cols = {"k": masked(np.arange(40), np.zeros(40, bool)),
            "v": (np.arange(40, dtype=np.int32), None)}
    specs = specs_for(("v",))
    for k in CARDS:
        got, took = run(k, cols, ["k"], specs)
        assert took
        assert_agg_equal(got, REF.group_by_agg(cols, ["k"], specs))


# ---------------------------------------------------------------------------
# integers: bit for bit, across key dtypes
# ---------------------------------------------------------------------------

KEY_DTYPES = {
    # dtype: (lo, hi) of the keys
    "int8": (-100, 100),
    "int16": (-3000, -2000),
    "int32": (2**31 - 500, 2**31 - 1),
    "int64": (-2**62, -2**62 + 400),
    "uint8": (0, 255),
    "uint64": (2**63 + 5, 2**63 + 300),
}
VALUE_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint8)


def int_table(kdt: str, n: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    lo, hi = KEY_DTYPES[kdt]
    if kdt == "uint64":
        keys = np.uint64(lo) + r.integers(0, hi - lo, n).astype(np.uint64)
    else:
        keys = r.integers(lo, hi, n, dtype=np.int64).astype(kdt)
    cols = {"k": masked(keys, r.random(n) > 0.1)}
    for dt in VALUE_DTYPES:
        info = np.iinfo(dt)
        vals = r.integers(info.min, info.max, n, dtype=np.int64,
                          endpoint=True).astype(dt)
        cols[np.dtype(dt).name] = masked(vals, r.random(n) > 0.15)
    return cols


@pytest.mark.parametrize("k", CARDS)
@pytest.mark.parametrize("kdt", sorted(KEY_DTYPES))
def test_integer_results_bit_for_bit(k, kdt):
    """Values over each dtype's whole range, so SUMs wrap; MEAN is the
    wrapped SUM over the count in float64, exact."""
    cols = int_table(kdt, 400, seed=len(kdt))
    specs = specs_for([np.dtype(dt).name for dt in VALUE_DTYPES])
    got, took = run(k, cols, ["k"], specs)
    assert took
    assert_agg_equal(got, REF.group_by_agg(cols, ["k"], specs))
    if kdt != "int8":     # repro's vectorized rebases int8 keys in int8
        assert_agg_equal(got, VEC.group_by_agg(cols, ["k"], specs))


@pytest.mark.parametrize("k", CARDS)
def test_int8_sum_wraps_across_partitions(k):
    """Every partition's partial wraps, and so does their combine: the
    result is the reference's row-by-row int8 wrap."""
    n = 240
    cols = {"k": (np.arange(n) % 3, None),
            "v": (np.full(n, 100, np.int8), None)}
    specs = (("sum", "v", "s"), ("mean", "v", "m"), ("count", "v", "c"))
    got, took = run(k, cols, ["k"], specs)
    assert took
    want = REF.group_by_agg(cols, ["k"], specs)
    assert_agg_equal(got, want)
    exact = 100 * (n // 3)
    assert got["s"][0].tolist() == [(exact + 128) % 256 - 128] * 3
    assert int(got["s"][0][0]) != exact


# ---------------------------------------------------------------------------
# floats: SUM/MEAN in the carve-out, MIN/MAX bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", CARDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_sum_and_mean_repeat_bitwise(k, dtype):
    r = np.random.default_rng(11)
    n = 1000
    cols = {"k": (r.integers(0, 37, n), None),
            "v": masked(r.normal(size=n).astype(dtype), r.random(n) > 0.1)}
    specs = (("sum", "v", "s"), ("mean", "v", "m"))
    got, took = run(k, cols, ["k"], specs)
    assert took
    assert_agg_equal(got, REF.group_by_agg(cols, ["k"], specs),
                     carveout("s", "m", dtype=dtype))
    again, _ = run(k, cols, ["k"], specs)
    for c in got:
        assert got[c][0].tobytes() == again[c][0].tobytes(), c


def straddling(k: int) -> dict:
    """Groups whose rows fall in several partitions (chunks of
    ceil(n / k) rows): tied zeros of both signs in different
    partitions, a NaN in one partition only, and an all-NULL group."""
    n = 48
    keys = np.arange(n) % 4
    v = np.linspace(1.0, 2.0, n)
    ok = np.ones(n, bool)
    g0 = np.flatnonzero(keys == 0)      # +0.0 early, -0.0 late: MIN/MAX tie
    v[g0[: len(g0) // 2]] = 0.0
    v[g0[len(g0) // 2:]] = -0.0
    g1 = np.flatnonzero(keys == 1)      # -0.0 early, +0.0 late
    v[g1[: len(g1) // 2]] = -0.0
    v[g1[len(g1) // 2:]] = 0.0
    g2 = np.flatnonzero(keys == 2)      # one NaN, in the last partition
    v[g2[-1]] = np.nan
    ok[keys == 3] = False               # all NULL
    return {"k": (keys, None), "v": masked(v, ok)}


@pytest.mark.parametrize("k", CARDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_min_max_keep_ties_and_nan_across_partitions(k, dtype):
    cols = straddling(k)
    cols["v"] = (cols["v"][0].astype(dtype), cols["v"][1])
    specs = (("min", "v", "lo"), ("max", "v", "hi"))
    got, took = run(k, cols, ["k"], specs)
    assert took
    want = REF.group_by_agg(cols, ["k"], specs)
    assert_agg_equal(got, want)
    for c in ("lo", "hi"):
        assert got[c][0].tobytes() == want[c][0].tobytes(), c
    # the later row's zero wins the tie, and the NaN poisons its group
    assert np.signbit(got["lo"][0][:2]).tolist() == [True, False]
    assert np.isnan(got["lo"][0][2]) and np.isnan(got["hi"][0][2])


# ---------------------------------------------------------------------------
# the kernels, the combine and the span
# ---------------------------------------------------------------------------

@pytest.fixture
def wrappers(monkeypatch):
    """Counts the backend's calls of each segment wrapper (on the CPU
    they run the plain versions and count no launch)."""
    calls = {"masked_segment_sum": 0, "masked_segment_reduce": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(part, name, counting(name, getattr(part, name)))
    return calls


@pytest.mark.parametrize("k", CARDS)
def test_partials_and_combine_run_through_the_segment_kernels(k, wrappers):
    """Per source: a SUM (with the counts) and a MIN; per owner, with
    more than one source: the counts, the SUM and the MIN combined."""
    cols = adversarial(400, 5)
    specs = (("sum", "v32", "s"), ("min", "v32", "lo"),
             ("count", "v32", "n"))
    got, took = run(k, cols, ["ki"], specs)
    assert took
    combines = k if k > 1 else 0
    assert wrappers == {"masked_segment_sum": k + 2 * combines,
                        "masked_segment_reduce": k + combines}
    assert_agg_equal(got, REF.group_by_agg(cols, ["ki"], specs))


def test_span_names_cards_rows_slots_and_bytes():
    cols = adversarial(300, 6)
    specs = (("sum", "v32", "s"), ("max", "f", "hi"))
    with tracing() as rec:
        PartitionedBackend(device="cpu", devices=["cpu"] * 3,
                           partitions=6).group_by_agg(cols, ["ki"], specs)
    (span,) = partial_spans(rec)
    a = span.attrs
    assert (a["cards"], a["partitions"], a["rows"], a["slots"]) == (
        3, 6, 300, 10)                  # keys -3..5, and the NULL slot
    seg_shard = 2                       # next_pow2(ceil(10 / 6))
    lane = (4 + 4) + (4 + 8)            # counts + int32 SUM, float64 MAX
    assert a["exchange_bytes"] == lane * seg_shard * 6 * 5
    # partitions p and p + 3 share a card: 6 * 4 of the 30 pairs cross
    assert a["peer_bytes"] == lane * seg_shard * 6 * 4


# ---------------------------------------------------------------------------
# what the partial path does not take
# ---------------------------------------------------------------------------

def ineligible(case: str, monkeypatch) -> tuple[dict, list, tuple]:
    r = np.random.default_rng(8)
    n = 300
    cols = adversarial(n, 7)
    specs = specs_for(("v32", "f"))
    keys = ["ki"]
    if case == "float_key":
        keys = ["f"]
        specs = specs_for(("v32",))
    elif case == "two_keys":
        cols["k2"] = (r.integers(0, 3, n), None)
        keys = ["ki", "k2"]
    elif case == "span_over_table":
        monkeypatch.setattr(part, "MAX_TABLE_SPAN", 64)
        cols["ki"] = (r.integers(0, 100, n), None)
    elif case == "sparse_span":
        cols["ki"] = (r.integers(0, 10**9, n), None)
    elif case == "bfloat16_value":
        cols["b"] = masked(bfloat16.from_float32(
            r.normal(size=n).astype(np.float32)), r.random(n) > 0.1)
        specs = specs_for(("b", "v32"))
    elif case == "object_value":
        cols["o"] = (np.array([int(x) for x in r.integers(0, 9, n)],
                              dtype=object), None)
        specs = specs_for(("o",))
    return cols, keys, specs


@pytest.mark.parametrize("case", ["float_key", "two_keys",
                                  "span_over_table", "sparse_span",
                                  "bfloat16_value", "object_value"])
def test_ineligible_inputs_take_the_inherited_path(case, monkeypatch):
    cols, keys, specs = ineligible(case, monkeypatch)
    got, took = run(3, cols, keys, specs)
    assert not took
    want = INHERITED.group_by_agg(cols, keys, specs)
    assert list(got) == list(want)
    for c in want:
        assert got[c][0].tobytes() == want[c][0].tobytes() or (
            got[c][0].dtype == object
            and got[c][0].tolist() == want[c][0].tolist()), c
