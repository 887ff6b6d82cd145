"""The port's sharding rules (``repro_torch.distributed.sharding``)
against ``repro``'s: ``AxisRules.resolve`` and ``safe_spec`` equal as
tuples for every rule set, kind, knob and mesh shape; the DTensor
placements a spec maps to; ``lshard`` outside rules."""
import itertools

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.distributed.sharding as RS
import repro_torch.distributed.sharding as TS

NAMES = ["batch", "seq", "embed", "heads", "kv_heads", "head_dim", "ff",
         "vocab", "experts", "expert_cap", "kv_seq", "p_embed_vocab",
         "p_heads", "p_kv_heads", "p_ff", "p_embed", "p_experts",
         "p_moe_inner", "layers", None, "unknown"]

# (axis names, sizes): the production meshes, the host meshes the tests
# and the card use, and a pipe-only mesh
MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (1, 2)), (("data", "model"), (2, 1)),
          (("data", "model"), (2, 2)),
          (("pod", "data", "model"), (2, 2, 2)), (("pipe",), (2,))]

KINDS = [("train", {}), ("train", {"fsdp": True}),
         ("train", {"seq_parallel": True}),
         ("train", {"fsdp": True, "seq_parallel": True}),
         ("train", {"dp_only": True}), ("train", {"dp_only": True,
                                                  "fsdp": True}),
         ("prefill", {}), ("prefill", {"seq_parallel": True}),
         ("prefill", {"dp_only": True}), ("decode", {}),
         ("decode", {"fsdp": True})]


class _JaxMeshShape:
    """What ``repro``'s rules read of a mesh: axis names and sizes."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _rules(kind, knobs, names, sizes):
    jm = _JaxMeshShape(names, sizes) if names else None
    tm = TS.MeshShape(names, sizes) if names else None
    return (RS.make_rules(kind, jm, **knobs),
            TS.make_rules(kind, tm, **knobs))


def test_rule_tables_equal():
    for name in ("TRAIN_RULES", "FSDP_RULES", "SP_SUFFIX", "DECODE_RULES",
                 "DP_ONLY_RULES"):
        assert getattr(TS, name) == getattr(RS, name), name


@pytest.mark.parametrize("kind,knobs", KINDS,
                         ids=[f"{k}-{'-'.join(v) or 'plain'}"
                              for k, v in KINDS])
@pytest.mark.parametrize("mesh", MESHES + [((), ())],
                         ids=[f"{'x'.join(map(str, s)) or 'nomesh'}"
                              for _, s in MESHES + [((), ())]])
def test_resolve_equals_repro(kind, knobs, mesh):
    names, sizes = mesh
    jr, tr = _rules(kind, knobs, names, sizes)
    assert jr.rules == tr.rules
    rng = np.random.default_rng(len(names) * 7 + len(kind))
    combos = [tuple(rng.choice(len(NAMES), size=n))
              for n in (1, 2, 3, 4) for _ in range(40)]
    combos += [(i,) for i in range(len(NAMES))]
    for combo in combos:
        logical = [NAMES[i] for i in combo]
        assert tuple(tr.resolve(*logical)) == tuple(jr.resolve(*logical)), \
            logical


@pytest.mark.parametrize("mesh", MESHES, ids=["x".join(map(str, s))
                                              for _, s in MESHES])
def test_safe_spec_equals_repro(mesh):
    names, sizes = mesh
    jm, tm = _JaxMeshShape(names, sizes), TS.MeshShape(names, sizes)
    entries = [None, *names, *itertools.combinations(names, 2)]
    dims = [1, 2, 7, 16, 24, 40, 256, 1500, 4096]
    rng = np.random.default_rng(sum(sizes))
    for _ in range(300):
        nd = int(rng.integers(1, 4))
        spec = [entries[int(rng.integers(len(entries)))] for _ in range(nd)]
        shape = tuple(int(dims[int(rng.integers(len(dims)))])
                      for _ in range(int(rng.integers(max(nd - 1, 1),
                                                      nd + 2))))
        want = RS.safe_spec(JP(*spec), shape, jm)
        got = TS.safe_spec(TS.PartitionSpec(*spec), shape, tm)
        assert tuple(got) == tuple(want), (spec, shape)


def test_partition_spec_normalizes_as_jax():
    for spec in [(("data",), None), ((), "model"), (("pod", "data"),),
                 ("data", ("model",))]:
        assert tuple(TS.PartitionSpec(*spec)) == tuple(JP(*spec))


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = TS.MeshShape(("pod", "data", "model"), (2, 2, 2))
    got = TS.placements(TS.PartitionSpec(("pod", "data"), None, "model"),
                        mesh)
    assert got == (Shard(0), Shard(0), Shard(2))
    assert TS.placements(TS.PartitionSpec(None, None), mesh) == \
        (Replicate(),) * 3
    _, pl = TS.named_sharding(TS.MeshShape(("data", "model"), (2, 2)),
                              "batch", "seq", "vocab",
                              rules=TS.AxisRules(TS.TRAIN_RULES))
    assert pl == (Shard(0), Shard(2))


def test_lshard_and_local_call_are_plain_outside_rules():
    x = torch.ones(4, 4)
    with TS.use_rules(None):
        assert TS.lshard(x, "batch", None) is x
    with TS.use_rules(TS.make_rules("train", TS.MeshShape(("data", "model"),
                                                          (2, 2)))):
        assert TS.lshard(x, "batch", None) is x     # not a DTensor
    assert TS.local_call(lambda a: a + 1, x, lead=1).sum() == 32
    assert TS.split_last(torch.ones(2, 6), 2, 3).shape == (2, 2, 3)
    assert TS.merge_last(torch.ones(2, 2, 3)).shape == (2, 6)
    assert torch.equal(TS.embedding(torch.tensor([2, 0]),
                                    torch.arange(12.).reshape(4, 3)),
                       torch.tensor([[6., 7., 8.], [0., 1., 2.]]))
