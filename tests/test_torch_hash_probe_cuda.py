"""The port's hash-probe CUDA kernels against their plain versions.

These run only on the card (``cuda`` marker; they skip without a CUDA
device). The file imports no JAX and no ``repro`` module, so it also
runs where only the port is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*_cuda.py``.
Every comparison is exact: int32 in, int32 out.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.hash_join import ops, ref

INT32_MAX = 2**31 - 1
SHAPES = [          # (probe lanes, table slots)
    (1000, 700),    # ragged against the Pallas tiling on both axes
    (512, 1024),    # exact block multiples
    (7, 3),         # smaller than any block
    (300, 1),       # a single slot
]


def _table(t, seed):
    """A (start, count) table built from a sorted build side of ~t/2 keys
    (some repeated, so runs longer than one; some slots empty)."""
    r = np.random.default_rng(seed)
    keys = r.integers(0, t, max(1, t // 2)).astype(np.int32)
    keys[::5] = keys[0]
    return ops.build_probe_table_np(np.sort(keys), t)


def _slots(n, t, seed):
    """Probe slots: hits and empty slots, plus negative, >= T, the int32
    sentinel and int32's minimum."""
    r = np.random.default_rng(seed + 1)
    slots = r.integers(0, t, n).astype(np.int32)
    special = np.array([-1, -7, t, t + 5, INT32_MAX, -2**31], np.int32)
    pick = r.random(n) < 0.2
    slots[pick] = r.choice(special, int(pick.sum()))
    mask = r.random(n) < 0.6
    return slots, mask


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,t", SHAPES + [(0, 5), (40, 0), (70_000, 3_000)])
def test_cuda_kernel_matches_plain(cuda, masked, n, t):
    if t:
        ts, tc = _table(t, seed=n)
    else:
        ts = tc = np.zeros(0, np.int32)
    slots, mask = _slots(n, max(t, 1), seed=n)
    dev = [torch.from_numpy(a).to(cuda) for a in (ts, tc, slots, mask)]
    before = (ops.masked_hash_probe if masked else ops.hash_probe).launches
    if masked:
        got = ops.masked_hash_probe(*dev)
        want = ref.masked_hash_probe_ref(*(d.cpu() for d in dev))
    else:
        got = ops.hash_probe(*dev[:3])
        want = ref.hash_probe_ref(*(d.cpu() for d in dev[:3]))
    torch.cuda.synchronize()
    after = (ops.masked_hash_probe if masked else ops.hash_probe).launches
    assert after == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


# The kernel's 16-byte body takes groups of 4 lanes where slots, outputs
# (16 bytes) and mask (4 bytes) align; a scalar head and tail take the
# rest, and every lane when the mask's phase differs from the slots'.
VECTOR_CASES = {   # label -> (n, slots view offset, mask offset, table
    #                           offset, mask: "half", "none" or "all")
    "n%4=0": (4000, 0, 0, 0, "half"),
    "n%4=1": (4001, 0, 0, 0, "half"),
    "n%4=2": (4002, 0, 0, 0, "half"),
    "n%4=3": (4003, 0, 0, 0, "half"),
    "n=1": (1, 0, 0, 0, "half"),
    "n=5": (5, 0, 0, 0, "half"),
    "slots[1:]": (4001, 1, 0, 0, "half"),
    "mask[1:]": (4002, 0, 1, 0, "half"),
    "slots[1:] mask[1:]": (4003, 1, 1, 0, "half"),
    "slots[3:] mask[3:]": (4000, 3, 3, 0, "half"),
    "table[1:]": (4001, 0, 0, 1, "half"),
    "mask all false": (4003, 0, 0, 0, "none"),
    "mask all true": (4002, 0, 0, 0, "all"),
    "n above 2^22": (2**22 + 3, 0, 0, 0, "half"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(VECTOR_CASES))
def test_cuda_vector_body_edges_match_plain(cuda, case):
    n, s_off, m_off, t_off, kind = VECTOR_CASES[case]
    t = 3000
    ts, tc = _table(t + t_off, seed=n)
    slots, mask = _slots(n + 3, t, seed=n + s_off)
    if kind != "half":
        mask[:] = kind == "all"
    ts_d, tc_d = (torch.from_numpy(a).to(cuda)[t_off:] for a in (ts, tc))
    slots_d = torch.from_numpy(slots).to(cuda)[s_off:s_off + n]
    mask_d = torch.from_numpy(mask).to(cuda)[m_off:m_off + n]
    got = (ops.hash_probe(ts_d, tc_d, slots_d),
           ops.masked_hash_probe(ts_d, tc_d, slots_d, mask_d))
    torch.cuda.synchronize()
    args = [x.cpu() for x in (ts_d, tc_d, slots_d, mask_d)]
    want = (ref.hash_probe_ref(*args[:3]), ref.masked_hash_probe_ref(*args))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == torch.int32 and torch.equal(a.cpu(), b)
