"""What both cells draw and compare, frozen: the digests of the tiny
cells' weights for ``SEED`` and of the full-size parameter lists (names,
shapes, dtypes, scales, in order), and every number the tiny cells'
CPU runs compare, with the control's, as the harness gave them before
the parameter list moved into the reference and the prefill judge took
layers of other kinds. The traced runs are used: their window is a
fixed count of steps, so the judged batches do not hang on the clock.
One CPU thread, so the sums run in one order wherever the test runs."""
import hashlib
import json

import pytest
import torch

from bench_port import harness
from bench_port.tests.tiny import CELLS, SEED, tiny_spec
from bench_port.weights import make_weights

FROZEN = {
    "granite-moe-3b.prefill-4x4096": {
        "weights": "8d4c6b28b947e9b5554b0bfb18fbf65c8f0665d4ea2286eb37ac9ce58fefb87e",
        "specs": "5a7cf334d1500027e51909c1664675fe31e37e8530753a2103006a40e138056e",
        "checks": {"kv_rel": 0.014491859823465347,
                   "logits_rel": 0.014269223436713219,
                   "route_shortfall": 0.0008248928934335709,
                   "route_unrecorded": 0.0, "served_gap": 0.0},
        "control": {"served_gap": 0.0, "logits_rel": 0.152818500995636,
                    "kv_rel": 0.26192668080329895, "route_unrecorded": 0.0,
                    "route_shortfall": 0.034152839332818985},
        "judged": 2},
    "phi4-mini-3b.decode-96x4096": {
        "weights": "4c3bf8aed4891b0253b14cf202201b3cea3b653f6b58f773107d45b978453b46",
        "specs": "189b187a4be2520421cd58a0f5a70aa67b2fbdabff9b9e638b414523cead4c38",
        "checks": {"logits_rel": 0.0129122668877244, "served_gap": 0.0},
        "control": {"served_gap": 0.05620163679122925,
                    "logits_rel": 0.17935454845428467},
        "judged": 14},
}


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def weights_digest(W: dict) -> str:
    h = hashlib.sha256()
    for name, t in W.items():
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def specs_digest(specs: dict) -> str:
    rows = [[n, list(shape), str(dtype), scale]
            for n, (shape, dtype, scale) in specs.items()]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.mark.parametrize("cell", CELLS)
def test_the_weights_and_parameter_lists_are_the_frozen_ones(cell):
    spec = tiny_spec(cell)
    m = spec.config["model"]
    W = make_weights(spec.ref.weight_specs(m), SEED, "cpu")
    assert weights_digest(W) == FROZEN[cell]["weights"]
    full = harness.load_spec(cell)
    assert specs_digest(full.ref.weight_specs(full.config["model"])) \
        == FROZEN[cell]["specs"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_compared_number_is_the_frozen_one(cell, one_thread):
    out = harness.run(tiny_spec(cell), SEED, 0.3, True, device="cpu",
                      control=True)
    assert {k: c["value"] for k, c in out["checks"].items()} \
        == FROZEN[cell]["checks"]
    assert out["control"] == FROZEN[cell]["control"]
    assert out["judged"] == FROZEN[cell]["judged"]
