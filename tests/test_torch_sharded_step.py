"""The port's sharded train step on eight gloo ranks on the CPU: the
smoke phi4-mini under ``make_rules("train", (2, 2, 2), seq_parallel=
True)`` (DP over pod and data, TP and sequence parallelism over model),
its parameters and optimizer state resharded DTensors, against
``repro``'s single-device step on the same weights and batch (ROADMAP
R3 rules out ``repro``'s own sharded step as the oracle). The bounds are
``tests/test_multidevice.py``'s: loss 1e-3, parameters rtol 5e-2 /
atol 5e-3."""
import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_host_mesh, run_ranks

ARCH = "phi4_mini_3b"
B, S = 4, 32
TIMEOUT_S = 300


def _sharded_step(rank, world, params, tokens):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.elastic import reshard
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.models.model import Model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import (TrainConfig,
                                                 make_sharded_train_step)
    cfg = get_smoke_config(ARCH)
    mesh = make_host_mesh(2, 2, pod=2, device="cpu")
    rules = make_rules("train", mesh, seq_parallel=True)
    placed = reshard(params, mesh, rules)
    opt = reshard(adamw_init(params), mesh, rules)
    step = make_sharded_train_step(
        cfg, AdamWConfig(lr=1e-3), TrainConfig(remat=None, device="cpu"),
        mesh, rules, model=Model(cfg, device="meta"))
    toks = torch.from_numpy(tokens)
    new_p, _, metrics = step(placed, opt, toks, toks)
    out = {k: v.full_tensor().float().numpy() for k, v in new_p.items()}
    return float(metrics["loss"].full_tensor()), out


def test_eight_rank_sp_step_matches_repros_single_device_step():
    cfg = jax_smoke(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    step = JT.make_train_step(cfg, JO.AdamWConfig(lr=1e-3),
                              JT.TrainConfig(remat=None, block_q=16,
                                             block_kv=16))
    p1, _, m1 = jax.jit(step)(jp, JO.adamw_init(jp), tokens, tokens)
    from repro_torch.configs import get_smoke_config
    want = params_from_jax(jax.tree.map(np.asarray, p1),
                           get_smoke_config(ARCH))
    start = params_from_jax(jax.tree.map(np.asarray, jp),
                            get_smoke_config(ARCH))
    outs = run_ranks(_sharded_step, 8, start, tokens, backend="gloo",
                     timeout_s=TIMEOUT_S, threads=1)
    for loss, got in outs:             # every rank holds the same step
        assert abs(loss - float(m1["loss"])) < 1e-3, (loss, m1["loss"])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k].float().numpy(),
                                       rtol=5e-2, atol=5e-3, err_msg=k)
