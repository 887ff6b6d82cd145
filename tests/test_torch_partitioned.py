"""The port's ``partitioned`` backend against ``repro``'s host backends.

``PartitionedBackend(device="cpu", partitions=p)`` runs the whole card
path on the CPU: key coding, the partition layout (``p`` key ranges,
probed one after another; ``p = 1`` is one card's identity layout; with
``devices=["cpu"] * k``, ``k`` cards, each partition on its own), the
table build and probe (the hash-probe kernels' plain versions) or the
sort-and-search hash mode, and the ragged emission. Its joins are held
against ``repro``'s ``reference`` oracle and ``vectorized`` backend on
the same column dicts, bit for bit: values (object columns by ``repr``,
so NaN and None compare), dtypes, validity and row order. No tolerance:
a join gathers rows and never adds.

``repro``'s ``sharded`` backend is not the yardstick: it needs
``jax.experimental.enable_x64``, which this JAX no longer has.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.data.tables import Table as JTable  # noqa: E402
from repro.exec.reference import ReferenceBackend  # noqa: E402
from repro.exec.vectorized import VectorizedBackend  # noqa: E402
from test_exec_backends import random_table  # noqa: E402

from repro_torch.exec import BackendUnavailable  # noqa: E402
from repro_torch.exec import partitioned as part  # noqa: E402
from repro_torch.exec.partitioned import PartitionedBackend  # noqa: E402
from repro_torch.exec.vectorized import (  # noqa: E402
    VectorizedBackend as PortVectorized)

REF = ReferenceBackend()
VEC = VectorizedBackend()
PORT_VEC = PortVectorized()
# one card with 1, 3 or 8 partitions, or a list of 2, 3 or 8 cards (one
# partition each, every card the CPU): the join's layout is the same,
# each partition probed on its own card
PARTITIONS = (1, 3, 8, ("cpu",) * 2, ("cpu",) * 3, ("cpu",) * 8)


def _layout_id(layout) -> str:
    return str(layout) if isinstance(layout, int) else f"{len(layout)}cards"


def make(layout) -> PartitionedBackend:
    if isinstance(layout, int):
        return PartitionedBackend(device="cpu", partitions=layout)
    return PartitionedBackend(device="cpu", devices=list(layout))


def n_parts(layout) -> int:
    return layout if isinstance(layout, int) else len(layout)
KEYSETS = (["ki"], ["ks"], ["f"], ["ki", "ks"], ["ks", "f"])
HOWS = ("inner", "left")


def _cols(t: JTable):
    return t._to_cols()


def assert_same(got, want):
    assert list(got) == list(want)
    for name in want:
        gv, gm = got[name]
        wv, wm = want[name]
        assert gv.dtype == wv.dtype, name
        n = len(wv)
        assert len(gv) == n, name
        gm = np.ones(n, bool) if gm is None else gm
        wm = np.ones(n, bool) if wm is None else wm
        assert np.array_equal(gm, wm), name
        assert [repr(x) for x in gv] == [repr(x) for x in wv], name


def check(left, right, on, how, partitions, *, left_mask=None,
          right_mask=None, yardsticks=(REF, VEC)):
    be = make(partitions)
    if left_mask is None and right_mask is None:
        got = be.hash_join(left, right, on, how)
        wants = [b.hash_join(left, right, on, how) for b in yardsticks]
    else:
        kw = dict(left_mask=left_mask, right_mask=right_mask)
        got = be.masked_hash_join(left, right, on, how, **kw)
        wants = [b.masked_hash_join(left, right, on, how, **kw)
                 for b in yardsticks]
    for want in wants:
        assert_same(got, want)
    return got


@pytest.fixture
def probes(monkeypatch):
    """Counts the partitioned backend's calls of each probe wrapper (on
    the CPU they run the plain versions and count no launch)."""
    calls = {"hash_probe": 0, "masked_hash_probe": 0}

    def counting(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    for name in calls:
        monkeypatch.setattr(part, name, counting(name, getattr(part, name)))
    return calls


# ---------------------------------------------------------------------------
# the differential fixtures of tests/test_exec_backends.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partitions", PARTITIONS, ids=_layout_id)
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("keys", KEYSETS, ids="+".join)
def test_random_tables_match(partitions, how, keys):
    """NULL and NaN keys (match nothing), string, float and multi-column
    keys (joint factorization), duplicate build keys (fan-out)."""
    for seed in (0, 1):
        left = _cols(random_table(200, seed))
        right = _cols(random_table(90, seed + 50))
        check(left, right, keys, how, partitions)


@pytest.mark.parametrize("partitions", PARTITIONS, ids=_layout_id)
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("keys", KEYSETS, ids="+".join)
def test_random_tables_with_masks_match(partitions, how, keys):
    r = np.random.default_rng(7)
    left = _cols(random_table(200, 3))
    right = _cols(random_table(90, 4))
    lm, rm = r.random(200) < 0.6, r.random(90) < 0.7
    check(left, right, keys, how, partitions, left_mask=lm)
    check(left, right, keys, how, partitions, right_mask=rm)
    check(left, right, keys, how, partitions, left_mask=lm, right_mask=rm)


# ---------------------------------------------------------------------------
# integer keys: table mode, rebased spans, hash mode on the device
# ---------------------------------------------------------------------------

INT_CASES = {
    # name: (left dtype, right dtype, lo, hi)
    "int32": (np.int32, np.int32, 0, 400),
    "int64_dense": (np.int64, np.int64, 0, 400),
    "int64_offset": (np.int64, np.int64, 2**40, 2**40 + 400),
    "int64_negative": (np.int64, np.int64, -300, 300),
    "int64_wide": (np.int64, np.int64, -10**15, 10**15),
    "int64_past_int32": (np.int64, np.int64, 0, 2**33),
    "int8": (np.int8, np.int8, -100, 100),
    "mixed_width": (np.int32, np.int64, 0, 500),
    "uint8_uint8": (np.uint8, np.uint8, 0, 200),
    "uint16": (np.uint16, np.uint16, 0, 60000),
    "uint64_past_int64": (np.uint64, np.uint64, 2**63, 2**64 - 1),
    "int_uint_cross_kind": (np.int64, np.uint32, 0, 300),
}


def _int_tables(case, seed, n_left=300, n_right=120):
    ldt, rdt, lo, hi = INT_CASES[case]
    r = np.random.default_rng(seed)
    if case == "uint64_past_int64":
        lk = np.uint64(lo) + r.integers(0, 1000, n_left).astype(np.uint64)
        rk = np.uint64(lo) + r.integers(0, 1000, n_right).astype(np.uint64)
    else:
        lk = r.integers(lo, hi, n_left, dtype=np.int64).astype(ldt)
        rk = r.integers(lo, hi, n_right, dtype=np.int64).astype(rdt)
    rk[: n_right // 3] = lk[: n_right // 3].astype(rdt)   # sure matches
    rk[n_right // 3: n_right // 2] = rk[0]                # duplicates
    lval = r.random(n_left) > 0.1                         # NULL keys
    rval = r.random(n_right) > 0.1
    left = {"k": (lk, lval), "a": (np.arange(n_left), None)}
    right = {"k": (rk, rval), "b": (r.normal(size=n_right), None)}
    return left, right


# repro's vectorized backend rebases int8 keys in int8 and fails on a
# span past 127 (ROADMAP R5); those cases hold against reference and
# the port's own vectorized backend, where the rebase widens first.
NARROW = {"int8"}


@pytest.mark.parametrize("partitions", PARTITIONS, ids=_layout_id)
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", sorted(INT_CASES))
def test_integer_keys_match(partitions, how, case):
    left, right = _int_tables(case, seed=len(case))
    r = np.random.default_rng(1)
    sticks = (REF, PORT_VEC) if case in NARROW else (REF, VEC)
    check(left, right, ["k"], how, partitions, yardsticks=sticks)
    check(left, right, ["k"], how, partitions,
          left_mask=r.random(300) < 0.5, right_mask=r.random(120) < 0.8,
          yardsticks=sticks)


@pytest.mark.parametrize("how", HOWS)
def test_port_vectorized_rebases_narrow_keys_in_int64(how):
    """An int8 key spanning more than 127 wraps if rebased in int8; the
    port's vectorized backend widens first and matches reference."""
    left, right = _int_tables("int8", seed=4)
    assert_same(PORT_VEC.hash_join(left, right, ["k"], how),
                REF.hash_join(left, right, ["k"], how))


@pytest.mark.parametrize("partitions", PARTITIONS, ids=_layout_id)
def test_table_mode_probes_through_the_kernels(partitions, probes):
    """A dense integer key takes table mode: the plain probe for a join,
    the filter-fused probe for an inner join with a left mask, and the
    plain probe for a left join with a left mask (it prefilters)."""
    left, right = _int_tables("int64_dense", seed=2)
    p = n_parts(partitions)
    check(left, right, ["k"], "inner", partitions)
    assert probes == {"hash_probe": p, "masked_hash_probe": 0}
    lm = np.random.default_rng(3).random(300) < 0.5
    check(left, right, ["k"], "inner", partitions, left_mask=lm)
    assert probes["masked_hash_probe"] == p
    check(left, right, ["k"], "left", partitions, left_mask=lm)
    assert probes == {"hash_probe": 2 * p, "masked_hash_probe": p}


@pytest.mark.parametrize("case", ["int64_wide", "int64_past_int32"])
def test_wide_int64_keys_stay_int64_in_hash_mode(case, probes):
    """Spans past int32 keep the raw int64 keys (no factorization, no
    degradation) and probe by sort and search, not the table."""
    left, right = _int_tables(case, seed=5)
    be = PartitionedBackend(device="cpu")
    lk, rk, span = be._device_keys(left, right, ["k"])
    assert span < 0 and lk.dtype == rk.dtype == np.int64
    check(left, right, ["k"], "inner", 1,
          left_mask=np.random.default_rng(0).random(300) < 0.5)
    assert probes == {"hash_probe": 0, "masked_hash_probe": 0}


def test_sentinel_stays_out_of_range_with_an_offset_base():
    """With several partitions a partition's base is > 0; the sentinel
    minus the base must stay out of its slot range, never wrap into it."""
    keys = np.array([0, 5, 64, 127, 128, 200, 2**31 - 1], np.int32)
    span_shard = 64
    b = part._buckets(keys, 4, span_shard)
    assert b.tolist() == [0, 0, 1, 1, 2, 3, 4]
    for d in range(4):
        slot = int(keys[-1]) - d * span_shard
        assert slot >= span_shard and slot <= 2**31 - 1


def test_partition_layout_keeps_row_order_per_range():
    keys = np.array([3, 9, 1, 9, 2, 2**31 - 1, 8, 0], np.int32)
    b = part._buckets(keys, 2, 8)
    slab, idx, cap = part._partition(keys, b, 2)
    assert slab.shape == idx.shape == (2, 2, cap)
    for s in range(2):
        for d in range(2):
            rows = idx[s, d][idx[s, d] >= 0]
            assert list(rows) == sorted(rows)
            assert (b[rows] == d).all()
    assert 5 not in idx                     # the sentinel row is dropped
    one = part._layout(keys, 1, 16)
    assert one[2] == len(keys) and one[1].ravel().tolist() == list(
        range(len(keys)))


# ---------------------------------------------------------------------------
# empty sides, no valid key, construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partitions", PARTITIONS, ids=_layout_id)
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("side", ["left", "right", "both"])
def test_empty_sides(partitions, how, side):
    left = _cols(random_table(0 if side != "right" else 50, 1))
    right = _cols(random_table(0 if side != "left" else 50, 2))
    check(left, right, ["ki"], how, partitions)


@pytest.mark.parametrize("how", HOWS)
def test_all_null_keys_match_nothing(how):
    left = {"k": (np.arange(40), np.zeros(40, bool)),
            "a": (np.arange(40.0), None)}
    right = {"k": (np.arange(10), None), "b": (np.arange(10), None)}
    for p in PARTITIONS:
        check(left, right, ["k"], how, p)


def test_cache_token_names_device_and_partitions():
    assert (PartitionedBackend(device="cpu", partitions=3).cache_token()
            == "partitioned[cpu;partitions=3]")
    assert (PartitionedBackend(device="cpu").cache_token()
            != PartitionedBackend(device="cpu", partitions=2).cache_token())
    # several cards: the token names every card
    assert (make(("cpu",) * 3).cache_token()
            == "partitioned[cpu,cpu,cpu;partitions=3]")


def test_cards_and_partitions():
    one = PartitionedBackend(device="cpu")
    assert (one.devices, one.cards, one.partitions) == (
        (torch.device("cpu"),), 1, 1)
    four = PartitionedBackend(device="cpu", devices=["cpu"] * 4)
    assert (four.cards, four.partitions, four.device) == (
        4, 4, torch.device("cpu"))
    six = PartitionedBackend(devices=["cpu"] * 3, partitions=6)
    assert (six.cards, six.partitions) == (3, 6)
    assert [six._card(p) for p in range(6)] == [torch.device("cpu")] * 6
    with pytest.raises(ValueError, match="at least one card"):
        PartitionedBackend(devices=[])
    with pytest.raises((ValueError, BackendUnavailable)):
        PartitionedBackend(devices=["cpu", "cuda:0"])


@pytest.mark.parametrize("partitions", [0, 256])
def test_partition_count_is_bounded(partitions):
    with pytest.raises(ValueError):
        PartitionedBackend(device="cpu", partitions=partitions)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        assert PartitionedBackend().device.type == "cuda"
        return
    with pytest.raises(BackendUnavailable, match="partitioned"):
        PartitionedBackend()
