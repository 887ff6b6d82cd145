"""The prefill judge on layers of other kinds than a (k, v) pair: what
a layer hands to its cache is a tuple of tensors with the position axis
at 2 (of any count and widths), or None; and the routing it follows is
that of the layers the reference names, no more and no fewer."""
import random
import types

import pytest
import torch

from bench_port import harness
from bench_port.kinds import prefill
from bench_port.reference import decoder
from bench_port.tests.tiny import SEED, tiny_spec


class _Stub:
    """A model whose first layer caches three tensors of different
    widths (one without a head axis) and whose second caches nothing."""

    def __call__(self, tokens, mode, return_kv):
        B, S = tokens.shape
        t = tokens.float()[:, None, :]
        kvs = [(t[..., None].expand(B, 2, S, 3) + 1,
                t[..., None].expand(B, 1, S, 5) * 2 + 1,
                t.expand(B, 4, S) - 0.5),
               None]
        return torch.randn(B, 1, 10), None, kvs


def _stub_ctx():
    return types.SimpleNamespace(
        traffic={"batch": 2, "prompt_len": 12, "sample_batches": 2,
                 "kv_positions": 4},
        m={"vocab_size": 10}, device=torch.device("cpu"), seed=SEED,
        rng=random.Random(0), model=_Stub())


def test_a_layer_of_three_tensors_and_one_of_none_are_judged():
    ctx = _stub_ctx()
    st = prefill.setup(ctx)
    prefill.window(ctx, st, steps=5)
    assert len(st["samples"]) == 2
    at = st["kv_pos"]
    for got in st["samples"].values():
        want = [tuple(t[:, :, at].clone() for t in _Stub()(
            prefill._tokens(ctx, got["i"]), "", True)[2][0]), None]
        assert [None if kv is None else [t.shape for t in kv]
                for kv in got["kv"]] == [[t.shape for t in want[0]], None]
        assert prefill._kv_rel(got["kv"], want) == 0.0
        # one position of the third tensor 10% off, over its 4 rows
        off = [tuple(t.clone() for t in want[0]), None]
        off[0][2][1, :, 2] *= 1.1
        assert prefill._kv_rel(got["kv"], off) == pytest.approx(
            0.1 / 1.1, rel=1e-5)
    # buffers made in set-up, one per tensor, reused by the samples
    assert [kv is None for kv in st["kv_bufs"][1]] == [False, True]
    assert len(st["kv_bufs"][1][0]) == 3


@pytest.mark.parametrize("change", ["a layer more", "None for tensors",
                                    "tensors for None", "a tensor fewer",
                                    "another width"])
def test_a_difference_in_structure_reads_one(change):
    g = [(torch.ones(2, 3, 4, 5), torch.ones(2, 1, 4, 7)), None]
    w = [(torch.ones(2, 3, 4, 5), torch.ones(2, 1, 4, 7)), None]
    assert prefill._kv_rel(g, w) == 0.0
    if change == "a layer more":
        w.append(None)
    elif change == "None for tensors":
        w[0] = None
    elif change == "tensors for None":
        w[1] = (torch.ones(2, 3, 4, 5),)
    elif change == "a tensor fewer":
        w[0] = w[0][:1]
    else:
        w[0] = (torch.ones(2, 3, 4, 5), torch.ones(2, 1, 4, 8))
    assert prefill._kv_rel(g, w) == 1.0


def test_a_pair_of_4d_tensors_reads_the_gap_over_heads_and_head_dim():
    gen = torch.Generator().manual_seed(5)
    w = [tuple(torch.randn(2, 3, 4, 5, generator=gen) for _ in range(2))]
    g = [tuple((t + 0.01 * torch.randn(t.shape, generator=gen))
               .bfloat16() for t in w[0])]
    want = max(float(((a.float() - b).norm(dim=(1, 3))
                      / b.norm(dim=(1, 3))).max()) for a, b in zip(g[0], w[0]))
    assert prefill._kv_rel(g, w) == want


def _routing_ctx(num_layers: int):
    m = {"num_layers": num_layers,
         "moe": {"group_size": 4, "experts_per_token": 2}}
    return types.SimpleNamespace(m=m, ref=decoder)


@pytest.mark.parametrize("short", [0, 1])
def test_a_record_one_short_of_the_routed_layers_is_unrecorded(short):
    ctx = _routing_ctx(3)
    B, S = 2, 8
    record = [torch.zeros(2, B, 4, 2, dtype=torch.long)
              for _ in range(len(decoder.routed_layers(ctx.m)) - short)]
    got = prefill._follow(ctx, record, B, S)
    if short:
        assert got is None
    else:
        assert [tuple(r.shape) for r in got] == [(B, 2, 4, 2)] * 3


def test_a_run_whose_record_is_one_short_reads_route_unrecorded():
    """The reference names one routed layer more than the program
    routes: the whole run says so (``route_unrecorded`` 1)."""
    ref = types.SimpleNamespace(**{n: getattr(decoder, n)
                                   for n in decoder.__all__})
    ref.routed_layers = lambda m: list(range(m["num_layers"] + 1))
    spec = tiny_spec("granite-moe-3b.prefill-4x4096")
    spec.ref = ref
    out = harness.run(spec, SEED, 0.3, False, device="cpu")
    assert not out["correct"]
    assert out["checks"]["route_unrecorded"]["value"] == 1
