"""The port's hash-probe kernels (``repro_torch/kernels/hash_join``).

On the CPU the wrappers run the plain PyTorch versions; these are held
against ``repro``'s JAX functions (the XLA gather oracle, and the Pallas
kernels in interpret mode) and the port's numpy floor against
``repro``'s. Every comparison is exact: int32 in, int32 out.

The CUDA kernels run only on the card: their parity tests are in
``test_torch_hash_probe_cuda.py``, which needs no JAX.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.hash_join import ops as jops  # noqa: E402
from repro.kernels.hash_join import ref as jref  # noqa: E402
from repro.kernels.hash_join.kernel import (  # noqa: E402
    hash_probe_kernel, masked_hash_probe_kernel)
from repro_torch.kernels.hash_join import kernel, ops, ref  # noqa: E402

INT32_MAX = 2**31 - 1
SHAPES = [          # (probe lanes, table slots)
    (1000, 700),    # ragged against the Pallas tiling on both axes
    (512, 1024),    # exact block multiples
    (7, 3),         # smaller than any block
    (300, 1),       # a single slot
]


def _table(t, seed, *, dup=True):
    """A (start, count) table built from a sorted build side of ~t/2 keys
    (some repeated, so runs longer than one; some slots empty)."""
    r = np.random.default_rng(seed)
    keys = r.integers(0, t, max(1, t // 2)).astype(np.int32)
    if dup:
        keys[::5] = keys[0]
    return jops.build_probe_table_np(np.sort(keys), t), keys


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


def _port(fn, *arrays):
    out = fn(*(torch.from_numpy(a) for a in arrays))
    return tuple(o.numpy() for o in out)


def _same(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == np.int32 and y.dtype == np.int32
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the plain versions against repro's JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t", SHAPES)
def test_plain_probe_matches_jax_oracle_and_pallas(n, t):
    (ts, tc), _ = _table(t, seed=n)
    slots, _ = _slots(n, t, seed=n)
    got = _port(ops.hash_probe, ts, tc, slots)
    _same(got, jref.hash_probe_ref(jnp.asarray(ts), jnp.asarray(tc),
                                   jnp.asarray(slots)))
    _same(got, hash_probe_kernel(jnp.asarray(ts), jnp.asarray(tc),
                                 jnp.asarray(slots), interpret=True))


@pytest.mark.parametrize("n,t", SHAPES)
def test_plain_masked_probe_matches_jax_oracle_and_pallas(n, t):
    (ts, tc), _ = _table(t, seed=n + 1)
    slots, mask = _slots(n, t, seed=n + 1)
    got = _port(ops.masked_hash_probe, ts, tc, slots, mask)
    args = (jnp.asarray(ts), jnp.asarray(tc), jnp.asarray(slots),
            jnp.asarray(mask))
    _same(got, jref.masked_hash_probe_ref(*args))
    _same(got, masked_hash_probe_kernel(*args, interpret=True))
    # a dropped lane gives (0, 0) whatever its slot
    assert not got[0][~mask].any() and not got[1][~mask].any()


@pytest.mark.parametrize("t", [1, 9, 700])
def test_build_probe_table_matches_jax(t):
    _, keys = _table(t, seed=t)
    srt = np.sort(np.r_[keys, np.int32(INT32_MAX), np.int32(-3)])
    got = ref.build_probe_table(torch.from_numpy(srt), t)
    _same([g.numpy() for g in got],
          jref.build_probe_table(jnp.asarray(srt), t))


def test_empty_lanes_and_empty_table():
    (ts, tc), _ = _table(16, seed=0)
    none = np.zeros(0, np.int32)
    slots, mask = _slots(40, 16, seed=0)
    _same(_port(ops.hash_probe, ts, tc, none), (none, none))
    got = _port(ops.hash_probe, none, none, slots)
    _same(got, (np.zeros(40, np.int32),) * 2)
    _same(got, jops.hash_probe_np(none, none, slots))
    _same(_port(ops.masked_hash_probe, none, none, slots, mask), got)


def test_sentinel_and_int32_extremes_miss():
    ts = np.arange(8, dtype=np.int32)
    tc = np.ones(8, dtype=np.int32)
    slots = np.array([INT32_MAX, -2**31, -1, 8, 7, 0], np.int32)
    got = _port(ops.hash_probe, ts, tc, slots)
    _same(got, (np.array([0, 0, 0, 0, 7, 0], np.int32),
                np.array([0, 0, 0, 0, 1, 1], np.int32)))


# The CUDA kernel takes 4 lanes at a time in 16-byte loads where the
# slots, mask and outputs align, and a scalar head and tail elsewhere; the
# plain versions must agree with repro's Pallas kernels on the inputs that
# split treats specially.
EDGE_CASES = {   # label -> (n, slots view offset, mask view offset, order,
    #                          mask: "random" or "none")
    "n=4k+1": (1001, 0, 0, "random", "random"),
    "n=4k+2": (1002, 0, 0, "random", "random"),
    "n=4k+3": (1003, 0, 0, "random", "random"),
    "slots[1:] mask[1:]": (1001, 1, 1, "random", "random"),
    "slots[3:] mask[1:]": (1002, 3, 1, "random", "random"),
    "clustered, then shuffled": (1003, 0, 0, "shuffled", "random"),
    "all masked": (1002, 0, 0, "random", "none"),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_plain_probes_match_pallas_on_vector_edges(case):
    n, s_off, m_off, order, kind = EDGE_CASES[case]
    t = 700
    (ts, tc), _ = _table(t, seed=n + s_off)
    slots, mask = _slots(n + 3, t, seed=n + m_off)
    if order == "shuffled":
        slots = np.random.default_rng(n).permutation(np.sort(slots))
    if kind == "none":
        mask[:] = False
    sv = torch.from_numpy(slots)[s_off:s_off + n]     # views, not copies
    mv = torch.from_numpy(mask)[m_off:m_off + n]
    assert sv.storage_offset() == s_off and mv.storage_offset() == m_off
    tt = (torch.from_numpy(ts), torch.from_numpy(tc))
    got = tuple(o.numpy() for o in ops.hash_probe(*tt, sv))
    got_m = tuple(o.numpy() for o in ops.masked_hash_probe(*tt, sv, mv))
    j = (jnp.asarray(ts), jnp.asarray(tc), jnp.asarray(sv.numpy()))
    _same(got, hash_probe_kernel(*j, interpret=True))
    _same(got_m, masked_hash_probe_kernel(*j, jnp.asarray(mv.numpy()),
                                          interpret=True))
    if kind == "none":
        assert not got_m[0].any() and not got_m[1].any()


@pytest.mark.parametrize("order", ["clustered", "random"])
def test_probe_inputs_hold_a_join_table_and_every_lane_kind(order):
    """``inputs.probe_inputs`` (the inputs ``chip_smoke.py`` checks the
    card's probes on), at a small size on the CPU: the table is the
    direct-address table of its build keys, the lanes hold hits, empty
    slots, negative, >= T and sentinel lanes (hits ascending when
    clustered), and the port's plain probes on them match ``repro``'s
    Pallas kernels in interpret mode."""
    from repro_torch.kernels.hash_join import inputs
    g = torch.Generator().manual_seed(3)
    t, m, n = 4096, 800, 3001
    ts, tc, slots, mask = inputs.probe_inputs(n, order, g, slots=t, keys=m,
                                              device="cpu")
    assert slots.dtype == ts.dtype == tc.dtype == torch.int32
    assert slots.shape == mask.shape == (n,) and ts.shape == (t,)
    assert int(tc.sum()) == m and bool((tc > 1).any())
    hit = tc > 0
    assert bool((ts[~hit] == m).all())       # an empty slot keeps start = m
    starts = ts[hit]                          # in slot order
    assert int(starts[0]) == 0 and int(starts[-1] + tc[hit][-1]) == m
    assert bool((starts[1:] == (starts + tc[hit])[:-1]).all())
    inr = (slots >= 0) & (slots < t)
    assert bool((slots < 0).any()) and bool((slots >= t).any())
    assert bool((slots == inputs.INT32_MAX).any())
    assert bool((tc[slots[inr].long()] == 0).any())
    # clustered: ascending but for the 13% of lanes drawn apart
    rising = float((slots[1:] >= slots[:-1]).double().mean())
    assert rising > 0.75 if order == "clustered" else rising < 0.6
    args = [x.numpy() for x in (ts, tc, slots)]
    j = tuple(jnp.asarray(a) for a in args)
    _same(_port(ops.hash_probe, *args), hash_probe_kernel(*j,
                                                          interpret=True))
    _same(_port(ops.masked_hash_probe, *args, mask.numpy()),
          masked_hash_probe_kernel(*j, jnp.asarray(mask.numpy()),
                                   interpret=True))


def _split_lanes(n, slots_ptr, mask_ptr, starts_ptr, counts_ptr):
    """The lanes of each path of the kernel, from kernel.lane_split."""
    head, groups = kernel.lane_split(n, slots_ptr, mask_ptr, starts_ptr,
                                     counts_ptr)
    body_end = head + 4 * groups
    return head, groups, (list(range(head)) + list(range(body_end, n)),
                          list(range(head, body_end)))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7, 8, 9, 4001, 4002,
                               4003, 4004])
def test_lane_split_covers_every_lane_once(n):
    """Every lane is in exactly one of the scalar head, the 16-byte body
    and the scalar tail; the body's first lane aligns slots, starts and
    counts to 16 bytes and the mask to 4; head and tail are under 4 lanes
    whenever one lane aligns them all."""
    base = 1 << 20
    for s_phase in range(4):
        for m_off in (None, 0, 1, 2, 3):
            for o_phase in (s_phase, 0):
                sp = base + 4 * s_phase
                mp = None if m_off is None else base + m_off
                op = base + 4 * o_phase
                head, groups, (scalar, body) = _split_lanes(n, sp, mp, op,
                                                            op + 64)
                assert sorted(scalar + body) == list(range(n))
                assert len(body) == 4 * groups
                if groups:
                    assert (sp + 4 * head) % 16 == 0
                    assert (op + 4 * head) % 16 == 0
                    assert mp is None or (mp + head) % 4 == 0
                    assert head < 4 and n - head - 4 * groups < 4
                aligned = (o_phase == s_phase and (
                    mp is None or (m_off - s_phase) % 4 == 0))
                if aligned and n >= head + 4:
                    assert groups == (n - head) // 4 > 0


def test_lane_split_refuses_unaligned_int32():
    assert kernel.lane_split(40, (1 << 20) + 2, None, 1 << 20,
                             1 << 21) == (40, 0)


@pytest.mark.parametrize("phase", range(4))
def test_outputs_take_the_slots_phase(phase):
    """The outputs are allocated at the slots' 16-byte phase, so a view of
    the slots at any offset keeps the 16-byte body."""
    slots = torch.zeros(64, dtype=torch.int32)[phase:phase + 50]
    sp = slots.data_ptr()
    assert sp % 16 == 4 * phase          # the CPU allocator aligns to 64
    out = kernel._empty_at_phase(slots)
    assert out.shape == (50,) and out.dtype == torch.int32
    assert out.is_contiguous() and out.data_ptr() % 16 == 4 * phase
    head, groups = kernel.lane_split(50, sp, None, out.data_ptr(),
                                     out.data_ptr())
    assert head == (4 - phase) % 4 and groups == (50 - head) // 4


# ---------------------------------------------------------------------------
# the numpy floor against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t", SHAPES + [(25, 0)])
def test_numpy_floor_matches_repro(n, t):
    if t:
        (ts, tc), keys = _table(t, seed=3 * n)
    else:
        ts = tc = keys = np.zeros(0, np.int32)
    slots, mask = _slots(n, max(t, 1), seed=3 * n)
    _same(ops.hash_probe_np(ts, tc, slots),
          jops.hash_probe_np(ts, tc, slots))
    _same(ops.masked_hash_probe_np(ts, tc, slots, mask),
          jops.masked_hash_probe_np(ts, tc, slots, mask))
    srt = np.sort(keys)
    _same(ops.build_probe_table_np(srt, t),
          jops.build_probe_table_np(srt, t))
    if t:    # and the plain version agrees with the floor
        _same(_port(ops.hash_probe, ts, tc, slots),
              ops.hash_probe_np(ts, tc, slots))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_cpu_calls_do_not_count_launches():
    before = (ops.hash_probe.launches, ops.masked_hash_probe.launches)
    (ts, tc), _ = _table(20, seed=1)
    slots, mask = _slots(50, 20, seed=1)
    _port(ops.hash_probe, ts, tc, slots)
    _port(ops.masked_hash_probe, ts, tc, slots, mask)
    assert (ops.hash_probe.launches,
            ops.masked_hash_probe.launches) == before


def test_wrappers_validate_inputs():
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.hash_probe(t, t[:3], t)
    with pytest.raises(ValueError):
        ops.masked_hash_probe(t, t, t, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        ops.hash_probe(t, t, t.reshape(2, 2))


@pytest.mark.parametrize("launch", [
    lambda t, m: kernel.hash_probe(t, t, t),
    lambda t, m: kernel.masked_hash_probe(t, t, t, m),
])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    """The CUDA wrappers launch on the card or raise: a CPU tensor never
    reaches a plain version through them (nothing is built to find that
    out)."""
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(4, dtype=torch.int32),
               torch.ones(4, dtype=torch.bool))


# ---------------------------------------------------------------------------
# the shared build helper (repro_torch/kernels/build.py)
# ---------------------------------------------------------------------------

def test_build_serves_the_library_of_this_source(tmp_path, monkeypatch):
    """The library's name carries the source's hash: a built library is
    served without running nvcc, and an edited source is not."""
    import hashlib

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    (tmp_path / f"libk-{digest}.so").write_bytes(b"")
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("nvcc ran"))
    assert build.build(src, "k") == (tmp_path / f"libk-{digest}.so", "")
    src.write_text("// two\n")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(src, "k")


def test_library_loads_once_across_threads(monkeypatch):
    """The engine runs a wave's nodes on threads: the first launches of
    two nodes may race to load a kernel library; it loads and binds
    once, and every thread gets the same handle."""
    import ctypes.util
    import sys
    import threading

    from repro_torch.kernels import build

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a kernel library")
    monkeypatch.setattr(build, "build", lambda *a, **k: (libc, ""))
    bound = []
    lib = build.CudaLibrary(kernel.SOURCE, "stand_in", bound.append)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(lib.load()))
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(bound) == 1 and len(got) == 32
    assert all(h is got[0] for h in got)
