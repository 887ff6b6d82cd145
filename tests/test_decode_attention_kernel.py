"""The port's decode attention: the live slot range against the mask, the
plain version against the decode core it was taken from, the wrapper's
checks, and (``cuda`` marker; they skip without a CUDA device) the
kernels against the plain version on the card.

The file imports no JAX and no ``repro`` module, so it also runs where
only the port is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_decode_attention_kernel.py``.

Tolerance of the kernels against the plain version, on the float32
output: both take the same float32 scores, softmax and weighted sum, but
sum in other orders (the scores over 8-element slices and a butterfly,
the softmax's sum per chunk and then over chunks, the weighted sum per
chunk and then over chunks), so they agree to ~1e-6 of max|v|; and a
probability whose two float32 values straddle a bfloat16 rounding
boundary rounds the other way, moving it by one bfloat16 step, at most
2^-7 of itself, and the output by at most that step · |v|. Two bounds
hold at once, each with 1e-5 of max|v| for the order of the sums:

- four such probabilities at the largest p of the case;
- the flips that can happen: every probability of the plain version
  whose float32 value lies within ``TIE_ULPS`` float32 steps (2^-14 of
  itself) of a bfloat16 rounding midpoint moves by its bfloat16 step,
  with the sign that hurts most, and no other moves. 2^-14 is a score
  difference of ~6e-5 between the two computations, where their float32
  sums differ by ~1e-6. A kernel that left p in float32, or dropped a
  chunk of slots, is ~1e-3 off and fails it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel, ops, ref

FLIPS = 4
TIE_ULPS = 512                   # float32 steps: 2^-14 of p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, K, g, smax, hd, device="cpu", seed=0, qdtype=torch.bfloat16):
    r = np.random.default_rng(seed)
    make = lambda *s: torch.from_numpy(
        r.standard_normal(s).astype(np.float32))
    q = make(B, K, g, hd).to(device, qdtype)
    k = make(B, K, smax, hd).to(device, torch.bfloat16)
    v = make(B, K, smax, hd).to(device, torch.bfloat16)
    return q, k, v


def _pre_change_core(qg, ck_m, cv_m, pos, smax, kind, local_window):
    """``models/layers.py``'s ``attention_decode`` between the cache
    write and the output projection, as it was before the kernels."""
    hd = qg.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                     ck_m.float()) / math.sqrt(hd)
    kpos = torch.arange(smax, device=qg.device)
    valid = (kpos <= pos) | (pos >= smax)
    if kind == "local" and local_window < smax:
        valid &= kpos > pos - local_window
    s = torch.where(valid, s, -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).to(cv_m.dtype)
    return torch.einsum("bkgs,bksd->bkgd", probs.float(), cv_m.float())


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _positions(smax, window):
    if smax > 64:
        return sorted({0, 1, smax // 2 - 1, smax // 2, smax - 1, smax,
                       smax + 1, 3 * smax // 2, 2 * smax - 2, 2 * smax - 1,
                       2 * smax, 5 * smax + 3})
    return range(0, 4 * smax + (window or 0) + 2)


@pytest.mark.parametrize("smax", [1, 2, 7, 16, 4096])
@pytest.mark.parametrize("kind,window", [("attn", None), ("local", 1),
                                         ("local", 5), ("local", 2048)])
def test_live_range_is_the_mask(smax, kind, window):
    """Every position, before and after the ring wraps: the slots the
    plain version's mask keeps are exactly ``lo .. hi``."""
    for pos in _positions(smax, window):
        lo, hi = ops.live_range(pos, smax, window)
        want = ref.valid_slots(pos, smax, window)
        got = torch.zeros(smax, dtype=torch.bool)
        got[lo:hi + 1] = True
        assert torch.equal(got, want), (pos, smax, window, lo, hi)


@pytest.mark.parametrize("kind,smax,pos", [
    ("attn", 16, 0), ("attn", 16, 9), ("attn", 16, 15), ("attn", 16, 40),
    ("local", 16, 3), ("local", 16, 11), ("local", 16, 30),
    ("local", 64, 5), ("local", 64, 100), ("local", 8, 100)])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plain_version_is_the_pre_change_core(kind, smax, pos, qdtype):
    """Seeded inputs: ``ref.py`` and the wrapper's CPU path give what the
    decode core gave, bit for bit (local window 12: shorter than some
    caches, longer than others, and past the whole cache at 100 of 64)."""
    q, k, v = _inputs(2, 2, 3, smax, 16, seed=pos, qdtype=qdtype)
    window = 12 if kind == "local" else None
    want = _pre_change_core(q, k, v, pos, smax, kind, 12)
    got = ref.decode_attention_ref(q, k, v, pos=pos, window=window)
    assert torch.equal(got, want)
    assert torch.equal(ops.decode_attention(q, k, v, pos=pos, window=window),
                       want)


@pytest.mark.parametrize("smax,window,pos", [(16, 4, 40), (8, 3, 10)])
def test_no_valid_slot_is_a_zero_query_over_every_slot(smax, window, pos):
    """The wrapper's stand-in when the window keeps no slot: the plain
    version's uniform softmax over all slots equals a zero query's."""
    lo, hi = ops.live_range(pos, smax, window)
    assert lo > hi and not ref.valid_slots(pos, smax, window).any()
    q, k, v = _inputs(1, 2, 4, smax, 32, seed=smax)
    want = ref.decode_attention_ref(q, k, v, pos=pos, window=window)
    got = ref.decode_attention_ref(torch.zeros_like(q), k, v, pos=smax - 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("live", [1, 2, 63, 64, 65, 1000, 2049, 4096, 65536])
@pytest.mark.parametrize("blocks,resident", [(1, 132), (8, 1056), (768, 1056),
                                             (96, 264), (100000, 1056)])
def test_split_covers_the_live_slots(live, blocks, resident):
    """Chunks the C side takes: every one non-empty, together the live
    slots, at least MIN_CHUNK slots each unless one chunk takes all."""
    splits, chunk = kernel.split(live, blocks, resident)
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < live <= splits * chunk
    assert splits == 1 or chunk >= kernel.MIN_CHUNK
    assert splits <= max(1, math.ceil(kernel.WAVES * resident / blocks))


def _bad(case):
    q, k, v = _inputs(2, 2, 3, 16, 32)
    if case == "q-dtype":
        q = q.half()
    elif case == "k-dtype":
        k = k.float()
    elif case == "v-dtype":
        v = v.half()
    elif case == "hd":
        q, k, v = (t[..., :24] for t in (q, k, v))
    elif case == "k-shape":
        k = k[:, :1]
    elif case == "v-shape":
        v = v[:, :, :8]
    elif case == "q-dims":
        q = q[0]
    elif case == "device":
        pass            # the right shapes, on the CPU
    return q, k, v


@pytest.mark.parametrize("case,error", [
    ("q-dtype", TypeError), ("k-dtype", TypeError), ("v-dtype", TypeError),
    ("hd", ValueError), ("k-shape", ValueError), ("v-shape", ValueError),
    ("q-dims", ValueError), ("device", ValueError)])
def test_kernel_wrapper_raises(case, error):
    q, k, v = _bad(case)
    with pytest.raises(error):
        kernel.decode_attention(q, k, v, lo=0, live=4)


class _OnCard:
    """Stands in for a sharded tensor on the card: four dims, a CUDA
    device."""
    device = torch.device("cuda", 0)

    def dim(self):
        return 4


def test_wrapper_raises_on_a_dtensor_on_the_card(monkeypatch):
    """No plain fallback for sharded tensors on the card: the kernels
    lack the cross-rank exchange, and the call says so."""
    monkeypatch.setattr(ops, "_is_dtensor", lambda t: True)
    with pytest.raises(NotImplementedError, match="section 7"):
        ops.decode_attention(_OnCard(), _OnCard(), _OnCard(), pos=3)


def test_wrapper_raises_on_shape_and_devices():
    q, k, v = _inputs(2, 2, 3, 16, 32)
    with pytest.raises(ValueError, match="4-D"):
        ops.decode_attention(q[0], k, v, pos=3)
    with pytest.raises(ValueError, match="several devices"):
        ops.decode_attention(q, k.to("meta"), v, pos=3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _tie_flips(p, v):
    """(B, K, g, hd): the most the output moves if every probability of
    ``p`` (float32, the plain version's) within ``TIE_ULPS`` float32
    steps of a bfloat16 rounding midpoint rounds the other way."""
    bits = p.view(torch.int32)
    near = ((bits & 0xFFFF) - 0x8000).abs() <= TIE_ULPS
    down = (bits & ~0xFFFF).view(torch.float32)
    step = (bits.bitwise_or(0xFFFF) + 1).view(torch.float32) - down
    return torch.einsum("bkgs,bksd->bkgd", torch.where(near, step, 0),
                        v.float().abs())


def _check_close(got, want, q, k, v, pos, window):
    """The module docstring's two bounds."""
    q, k, v, got, want = (t.cpu() for t in (q, k, v, got, want))
    smax, hd = k.shape[2], q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float()) / math.sqrt(hd)
    s = torch.where(ref.valid_slots(pos, smax, window), s, ref.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)      # as ref.py computes it
    vmax = float(v.float().abs().max())
    order = 1e-5 * vmax
    diff = (got - want).abs()
    err = float(diff.max())
    atol = FLIPS * 2 ** -7 * float(p.max()) * vmax + order
    assert err <= atol, (err, atol, vmax)
    ties = _tie_flips(p, v) + order
    worst = int((diff - ties).argmax())
    assert bool((diff <= ties).all()), (
        err, float(diff.flatten()[worst]), float(ties.flatten()[worst]))


CASES = {                        # B, smax, pos, window
    "fresh": (2, 64, 0, None),
    "partial": (3, 300, 137, None),
    "wrapped": (2, 256, 700, None),
    "local": (2, 256, 180, 64),
    "local-wrapped": (1, 256, 300, 64),
    "local-none-valid": (1, 64, 200, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("g", [1, 3, 4, 5])
@pytest.mark.parametrize("hd", kernel.HEAD_DIMS)
def test_cuda_kernel_matches_plain(cuda, hd, g, case):
    B, smax, pos, window = CASES[case]
    q, k, v = _inputs(B, 2, g, smax, hd, cuda, seed=hd + g + pos)
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, pos=pos, window=window)
    again = ops.decode_attention(q, k, v, pos=pos, window=window)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q.cpu(), k.cpu(), v.cpu(), pos=pos,
                                    window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, again)             # a fixed order of sums
    assert ops.decode_attention.launches == before + 2
    _check_close(got, want, q, k, v, pos, window)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", kernel.HEAD_DIMS)
def test_cuda_kernel_takes_a_float32_query(cuda, hd):
    """A float32 model's q, whose values bfloat16 does not hold, read as
    it is."""
    q, k, v = _inputs(2, 2, 3, 200, hd, cuda, seed=hd, qdtype=torch.float32)
    got = ops.decode_attention(q, k, v, pos=150)
    want = ref.decode_attention_ref(q, k, v, pos=150)
    torch.cuda.synchronize()
    _check_close(got, want, q, k, v, 150, None)
    bf = ops.decode_attention(q.bfloat16(), k, v, pos=150)
    assert not torch.equal(got, bf)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [2047, 3071, 4095])
def test_cuda_kernel_at_the_decode_cells_shape(cuda, pos):
    """96 sessions, 8 kv heads of 3 query heads, hd 128, a 4096-slot
    ring: the phi4-mini decode cell's shape."""
    q, k, v = _inputs(96, 8, 3, 4096, 128, cuda, seed=pos)
    got = ops.decode_attention(q, k, v, pos=pos)
    want = ref.decode_attention_ref(q, k, v, pos=pos)
    torch.cuda.synchronize()
    _check_close(got, want, q, k, v, pos, None)


@pytest.mark.cuda
def test_cuda_kernel_reads_no_slot_outside_the_range(cuda):
    """NaN in every slot outside the live range changes nothing: the
    kernels never read them (the plain version would turn NaN)."""
    q, k, v = _inputs(2, 2, 3, 128, 64, cuda, seed=5)
    pos, window = 150, 40            # slots 111 .. 127 of a wrapped ring
    lo, hi = ops.live_range(pos, 128, window)
    want = ops.decode_attention(q, k, v, pos=pos, window=window)
    for t in (k, v):
        t[:, :, :lo] = float("nan")
        t[:, :, hi + 1:] = float("nan")
    got = ops.decode_attention(q, k, v, pos=pos, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_a_dtensor(cuda):
    """A cache sharded over its slots, as the decode rules shard it, on a
    one-rank mesh of the card: the call raises where the plain version
    would have run."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,))
        q, k, v = _inputs(2, 2, 3, 64, 32, cuda)
        qd = distribute_tensor(q, mesh, [Replicate()])
        kd, vd = (distribute_tensor(t, mesh, [Shard(2)]) for t in (k, v))
        before = ops.decode_attention.launches
        with pytest.raises(NotImplementedError, match="section 7"):
            ops.decode_attention(qd, kd, vd, pos=40)
        assert ops.decode_attention.launches == before
    finally:
        dist.destroy_process_group()
