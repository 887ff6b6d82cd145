"""The port's int8 gradient compression (``repro_torch.distributed.
grad_compression``): the quantizer bit for bit against ``repro``'s, and
the compressed all-reduce with error feedback on two ``pod`` ranks
(gloo, on the CPU) against ``repro``'s on a forced 8-device (2, 2, 2)
mesh (a subprocess)."""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.grad_compression import (dequantize_int8 as j_deq,
                                                quantize_int8 as j_quant)
from repro_torch.distributed.grad_compression import (compressed_psum_pod,
                                                      dequantize_int8,
                                                      quantize_int8)
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch.mesh import make_host_mesh, run_ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180
STEPS = 3


def _cases():
    rng = np.random.default_rng(0)
    ties = (np.arange(-600, 600) / 2.0).astype(np.float32)  # x.5 ties
    return {"normal_1000": rng.normal(size=(1000,)).astype(np.float32),
            "matrix_pad": rng.normal(size=(37, 29)).astype(np.float32),
            "exact_block": rng.normal(size=(4, 256)).astype(np.float32),
            "ties": ties, "zeros": np.zeros((300,), np.float32),
            "tiny": (rng.normal(size=(513,)) * 1e-20).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_cases()))
@pytest.mark.parametrize("block", [256, 64])
def test_quantize_int8_is_bitwise_repros(name, block):
    x = _cases()[name]
    jq, js = j_quant(jnp.asarray(x), block)
    tq, ts = quantize_int8(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back_j = j_deq(jq.astype(jnp.int32), js, x.size, x.shape)
    back_t = dequantize_int8(tq.to(torch.int32), ts, x.size, x.shape)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def test_no_pod_axis_passes_through():
    g = {"w": torch.ones(8, 8)}
    red, err = compressed_psum_pod(g, MeshShape(("data", "model"), (2, 2)))
    assert red["w"] is g["w"] and torch.equal(err["w"], torch.zeros(8, 8))


@pytest.fixture(scope="module")
def repro_steps():
    """``repro``'s compressed psum on a (2, 2, 2) mesh of 8 forced host
    devices: the reduced value and the error state after each of
    ``STEPS`` steps of the same gradient."""
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json
        import jax, jax.numpy as jnp, numpy as np
        from repro.distributed.grad_compression import compressed_psum_pod
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        g = {{"w": jnp.asarray(np.random.default_rng(0).normal(
            size=(512,)).astype(np.float32)),
             "b": jnp.asarray(np.random.default_rng(1).normal(
            size=(7, 5)).astype(np.float32))}}
        err, out = None, []
        for _ in range({STEPS}):
            red, err = compressed_psum_pod(g, mesh, error=err)
            out.append({{k: [np.asarray(red[k]).tolist(),
                            np.asarray(err[k]).tolist()] for k in g}})
        print("STEPS" + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("STEPS"))
    return json.loads(line[len("STEPS"):])


def _two_pods(rank, world):
    mesh = make_host_mesh(1, 1, pod=2, device="cpu")
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(512,)).astype(np.float32)),
         "b": torch.from_numpy(np.random.default_rng(1).normal(
             size=(7, 5)).astype(np.float32))}
    err, out = None, []
    for _ in range(STEPS):
        red, err = compressed_psum_pod(g, mesh, error=err)
        out.append({k: [red[k].numpy(), err[k].numpy()] for k in g})
    return out


def test_two_pod_ranks_match_repros_8_device_mesh(repro_steps):
    outs = run_ranks(_two_pods, 2, backend="gloo", timeout_s=TIMEOUT_S,
                     threads=1)
    g = np.random.default_rng(0).normal(size=(512,)).astype(np.float32)
    for steps in outs:
        for got, want in zip(steps, repro_steps):
            for k in ("w", "b"):
                red, err = got[k]
                np.testing.assert_array_equal(
                    red, np.asarray(want[k][0], np.float32), err_msg=k)
                np.testing.assert_array_equal(
                    err, np.asarray(want[k][1], np.float32), err_msg=k)
        # the reference's gate: the reduced value within max|g|/100
        np.testing.assert_allclose(steps[0]["w"][0], g, rtol=0,
                                   atol=float(np.abs(g).max()) / 100)
