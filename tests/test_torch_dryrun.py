"""The port's dry-run (``repro_torch.launch.{specs,dryrun,mesh}``):
per-rank argument bytes of every (arch × shape) cell on the (16, 16)
production mesh equal ``repro``'s ``NamedSharding.shard_shape`` sums
(JAX in a subprocess with 256 forced host devices), and a cell's row on
one card and on a fake 256-rank process group."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import arg_bytes_per_device, build_cell

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def repro_bytes():
    """{arch.shape: bytes one device holds of the cell's arguments} from
    ``repro``'s ``build_cell`` on its (16, 16) mesh; the caches' int32
    lengths are left out (the port keeps them on the host)."""
    script = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
        import json, math
        import jax
        import numpy as np
        from repro.configs import ARCHS, get_config
        from repro.configs.base import SHAPES
        from repro.launch.mesh import make_production_mesh
        from repro.launch.specs import build_cell
        mesh = make_production_mesh()
        out = {}
        for arch in ARCHS:
            for name, shape in SHAPES.items():
                plan = build_cell(get_config(arch), shape, mesh)
                total = 0
                for arg, sh in zip(plan.args, plan.in_shardings):
                    leaves = jax.tree_util.tree_leaves_with_path(arg)
                    shs = jax.tree.leaves(sh)
                    for (path, leaf), s in zip(leaves, shs):
                        if path and str(path[-1]) == "['len']":
                            continue
                        n = math.prod(s.shard_shape(leaf.shape))
                        total += n * np.dtype(leaf.dtype).itemsize
                out[f"{arch}.{name}"] = total
        print("BYTES" + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("BYTES"))
    return json.loads(line[len("BYTES"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_per_device_equal_repro(arch, repro_bytes):
    mesh = make_production_mesh()
    for name, shape in SHAPES.items():
        plan = build_cell(get_config(arch), shape, mesh)
        assert arg_bytes_per_device(plan, mesh) == \
            repro_bytes[f"{arch}.{name}"], (arch, name)


def test_production_meshes():
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512


def test_one_card_cell_counts_the_prefill():
    """A one-card cell, as chip_smoke.py's 11a runs it: the parameters'
    bytes exactly, FLOPs of the products and of flash's live pairs, no
    collective."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention.ops import live_pairs
    from repro_torch.models.model import Model
    cfg = get_config("phi4_mini_3b")
    mesh = MeshShape(("data", "model"), (1, 1))
    B, S = 4, 1024
    plan = build_cell(cfg, ShapeConfig("prefill_4x1024", S, B, "prefill"),
                      mesh)
    params = sum(p.numel() * p.element_size()
                 for p in Model(cfg, device="meta").parameters())
    assert arg_bytes_per_device(plan, mesh, only=(0,)) == params
    assert arg_bytes_per_device(plan, mesh) == params + B * S * 4
    cost = dryrun.trace_cell(plan, mesh)
    assert cost.collective_bytes == 0 and cost.saved_bytes == 0
    assert cost.kernel_flops == {"flash_attention": 4 * cfg.head_dim * (
        live_pairs(S, S, True, None) * B * cfg.num_heads * cfg.num_layers)}
    # the products: ~2 FLOPs a parameter a token, less the embedding
    # lookup and the head's unused positions
    assert 0.5 < (cost.flops - sum(cost.kernel_flops.values())) / \
        plan.model_flops < 1


def test_cli_writes_a_row_on_a_fake_256_rank_group(tmp_path):
    """``python -m repro_torch.launch.dryrun`` for one decode cell: the
    step runs on meta DTensors as rank 0 of a fake process group."""
    assert dryrun.main(["--arch", "phi4_mini_3b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    row = json.loads((tmp_path / "phi4_mini_3b.decode_32k.single.json")
                     .read_text())
    assert row["status"] == "ok" and row["chips"] == 256
    assert row["collective_bytes"] > 0 and row["hlo_flops"] > 0
    assert row["hbm_ok"] and 0 < row["roofline_fraction"] <= 1
    for key in ("memory_analysis", "lower_s", "compile_s",
                "xla_cost_analysis", "while_trips"):
        assert row[key].startswith("no counterpart"), key
    assert dryrun.main(["--arch", "phi4_mini_3b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    skip = json.loads((tmp_path / "phi4_mini_3b.long_500k.single.json")
                      .read_text())
    assert skip["status"] == "skipped"


def test_allocated_bytes_model_the_caching_allocator():
    from repro_torch.launch.specs import allocated_bytes
    MiB = 1 << 20
    assert allocated_bytes(1) == 512 and allocated_bytes(513) == 1024
    assert allocated_bytes(6 * MiB) == 6 * MiB          # shared segments
    assert allocated_bytes(18 * MiB) == 18 * MiB        # a 2 MiB multiple
    # phi4-mini's embedding: 1,173 MiB, a 1 MiB remainder in its segment
    # stays with the block
    assert allocated_bytes(200192 * 3072 * 2) == 1174 * MiB
    # half of it: a 1.5 MiB remainder is split off
    assert allocated_bytes(100096 * 3072 * 2) == 100096 * 3072 * 2
